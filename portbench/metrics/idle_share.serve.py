"""idle_share.serve: the share of the traced window of served frames in
which no operation ran on the device (``trace.Trace.idle_share``), in %."""


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "serve" or tr is None or not tr.device:
        return None
    return tr.idle_share()
