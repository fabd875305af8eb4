"""The trex command line of the port (counterpart of
``trex_tpu/cli/``)."""
