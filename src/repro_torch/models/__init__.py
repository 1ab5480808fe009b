"""Model families of the port. Only the paper's CNNs are ported so far
(``models.cnn``); the LM families follow (see ROADMAP.md)."""
