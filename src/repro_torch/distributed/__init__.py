"""Distributed optimisation. Only the numerics of the int8 error-feedback
gradient compression are here so far; the collectives themselves wait for
the distribution slice."""
