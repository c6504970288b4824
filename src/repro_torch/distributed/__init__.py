"""Step builders (port of ``repro.distributed``): the plain single-device
prefill and decode steps."""
