"""frames_per_s: frames completed over the window's host seconds."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return len(rec["frames"]) / rec["window_s"]
