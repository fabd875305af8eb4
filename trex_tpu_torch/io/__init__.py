"""The .pv container, its codec and the frame sources of the port
(counterparts of ``trex_tpu/io/``)."""
