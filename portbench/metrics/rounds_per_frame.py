"""rounds_per_frame: ``render_test``'s rounds (its alive-ray loop's
iterations), the mean over the traced window's frames."""


def read(rec):
    if rec["kind"] != "serve" or not rec["frames"]:
        return None
    return sum(f[1] for f in rec["frames"]) / len(rec["frames"])
