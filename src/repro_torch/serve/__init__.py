"""Batched serving of the LM families (``serve.serve_loop``)."""
