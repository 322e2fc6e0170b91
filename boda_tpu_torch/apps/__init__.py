"""The port's user-facing modes: run_cnet, cnet_predict, cls_agree, and the
trained-weights reader."""
