"""Detection: the facade and its backends, YOLO, tiling and region
proposals (the port of ``trex_tpu/detect/``)."""
