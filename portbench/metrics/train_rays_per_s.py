"""train_rays_per_s: rays trained over the whole window, the batch times
the steps completed over the window's host seconds (the window ends in a
synchronize and holds every occupancy refresh that falls in it)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["batch"] * rec["steps"] / rec["window_s"]
