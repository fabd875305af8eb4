"""Host tracking engines of the port: the FastTracker replay and the
device engine DeviceTracker (counterparts of ``trex_tpu/track/``)."""
