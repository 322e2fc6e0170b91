"""imgs_per_s (imgs/s, host clock): images whose logits reached the host in
the window, over the whole window, from the start of the first request to the
end of the last."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.answered * run.batch / run.window_s
