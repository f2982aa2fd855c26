"""The port's own copy of the few control-plane constants it needs."""
