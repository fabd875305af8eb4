"""Host utilities of the port (counterpart of ``trex_tpu/utils/``)."""
