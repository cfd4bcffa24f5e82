"""setup_s: host seconds from the process's start to the window's start
(building the scene, loading or building the kernels, the set-up's
training, graph captures and warm-up frames)."""


def read(rec):
    return rec["setup_s"]
