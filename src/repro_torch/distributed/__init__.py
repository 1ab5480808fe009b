"""Distribution on ``torch.distributed``: sharding rules and the logical-axis
context (DTensor placements on a DeviceMesh), the GPipe pipeline, and the
compressed gradient all-reduce."""
