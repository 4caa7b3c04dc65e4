"""Tools around the port's solver (ports of sdpb_tpu/tools/)."""
