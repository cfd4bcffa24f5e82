"""Per-dataset-family conventions as declarative tables (numpy).

A copy of ``mfnerf_tpu/datasets/conventions.py``: camera-axis frames,
resolution defaults, split-selection rules, per-scene bound fixes,
background fixes and exposure tables, kept as data so each loader is a thin
consumer. The COLMAP, HDR and RTMV tables come along for the loaders of a
later slice.

A "pose" everywhere below is a (3, 4) camera-to-world matrix in the
canonical camera frame: [right down front] (x right, y down, z into the
screen), the frame ``ray_utils.get_ray_directions`` emits rays in.
"""
import numpy as np

# --------------------------------------------------------------- axis frames
# Column sign-flips converting each source's camera axes into the canonical
# [right down front] frame. Keys are the source conventions, values are the
# per-column multipliers applied to c2w[:, :3].
AXIS_TO_RDF = {
    "rdf": (1, 1, 1),            # already canonical (NSVF pose files)
    "ldf": (-1, 1, 1),           # [left down front]  (NSVF test_traj files)
    "rub": (1, -1, -1),          # [right up back]    (Blender / RTMV json)
    "luf": (-1, -1, 1),          # [left up front]    (Jrender)
}


def to_rdf(c2w: np.ndarray, source: str) -> np.ndarray:
    """Flip pose columns from ``source`` axes into [right down front]."""
    out = np.asarray(c2w, dtype=np.float64).copy()[:3]
    out[:, :3] *= np.asarray(AXIS_TO_RDF[source], out.dtype)[None, :]
    return out


def bound_into_unit_box(c2w: np.ndarray, shift, scale2) -> np.ndarray:
    """Translate by -shift and divide by ``scale2`` (= 2*scene_scale) so the
    scene bbox lands in [-0.5, 0.5]^3 (reference nsvf.py:20-27 semantics)."""
    out = c2w.copy()
    out[:, 3] = (out[:, 3] - shift) / scale2
    return out


# ------------------------------------------------------------- NSVF families
# (substring-of-root_dir, dict) — first match wins; None key = fallthrough.
# fx_from_first_float: intrinsics.txt holds a single focal as its first
# token (Synthetic_*/Ignatius); otherwise it is a full 4x4/3x3 K matrix.
NSVF_FAMILIES = (
    ("Synthetic", dict(wh=(800, 800), fx_from_first_float=True)),
    ("Ignatius", dict(wh=(1920, 1080), fx_from_first_float=True)),
    ("BlendedMVS", dict(wh=(768, 576), fx_from_first_float=False)),
    ("Tanks", dict(wh=(1920, 1080), fx_from_first_float=False)),
    (None, dict(wh=(800, 800), fx_from_first_float=False)),
)

# filename-prefix split selection (reference nsvf.py:75-81): NSVF scenes name
# images 0_* (train) / 1_* (val) / 2_* (test-synthetic)
NSVF_SPLIT_PREFIX = {
    "train": "0_",
    "trainval": "[0-1]_",
    "trainvaltest": "[0-2]_",
    "val": "1_",
    ("test", True): "2_",   # synthetic scenes have a real test set
    ("test", False): "1_",  # real scenes reuse val as test
}

# per-scene scene-bound enlargement on top of the global 1.05
# (reference nsvf.py:25-26: Mic/Lego content exceeds bbox.txt)
NSVF_BOUND_FIX = {"Mic": 1.2, "Lego": 1.1}
NSVF_BBOX_ENLARGE = 1.05

# scenes shot on black that train better composited onto white
# (reference nsvf.py:93-95)
NSVF_BLACK_TO_WHITE = ("Jade", "Fountain")


def match_family(root_dir: str, table):
    """First (substring, value) row of ``table`` whose key is in root_dir."""
    for key, value in table:
        if key is None or key in root_dir:
            return value
    raise KeyError(root_dir)


def scene_name(root_dir: str) -> str:
    """Last path component (reference's `root_dir.split('/')[-1]` idiom,
    tolerant of a trailing slash)."""
    parts = [p for p in root_dir.split("/") if p]
    return parts[-1] if parts else ""


# -------------------------------------------------------- Blender / Jrender
BLENDER_WH = (800, 800)
BLENDER_POSE_RADIUS = 1.5
# Jrender per-scene camera radii + post-normalization shifts
# (reference nerf.py:55-67)
JRENDER_RADIUS = {"Easyship": 1.2, "Scar": 1.8, "Coffee": 2.5, "Car": 0.8}
JRENDER_SHIFT = {"Coffee": (1, -0.4465), "Car": (0, -0.7)}  # (row, delta)

# ----------------------------------------------------------------- COLMAP
# mip-NeRF-360 distributions ship pre-downsampled folders images_{2,4,8}
MIPNERF360_MARKER = "360_v2"
COLMAP_TEST_EVERY = 8  # every 8th image is test (reference colmap.py:117-124)

# HDR-NeRF per-scene exposure tables (reference colmap.py:137-152)
HDR_EXPOSURES = {
    **{s: {e: 1 / 8 * 4 ** e for e in range(5)}
       for s in ["bathroom", "bear", "chair", "desk"]},
    **{s: {e: 1 / 16 * 4 ** e for e in range(5)}
       for s in ["diningroom", "dog"]},
    "sofa": {0: 0.25, 1: 1, 2: 2, 3: 4, 4: 16},
    "sponza": {0: 0.5, 1: 2, 2: 4, 3: 8, 4: 32},
    "box": {0: 2 / 3, 1: 1 / 3, 2: 1 / 6, 3: 0.1, 4: 0.05},
    "computer": {0: 1 / 3, 1: 1 / 8, 2: 1 / 15, 3: 1 / 30, 4: 1 / 60},
    "flower": {0: 1 / 3, 1: 1 / 6, 2: 0.1, 3: 0.05, 4: 1 / 45},
    "luckycat": {0: 2, 1: 1, 2: 0.5, 3: 0.25, 4: 0.125},
}
# HDR-NeRF unit-exposure target rgb (reference colmap.py:90,99)
HDR_UNIT_EXPOSURE_RGB = {"syndata": 0.73, "real": 0.5}

# ------------------------------------------------------------------- RTMV
RTMV_SPLITS = {"train": (0, 100), "trainval": (0, 105), "test": (105, 150),
               None: (0, 150)}
RTMV_BOUND_SCENES = ("bricks",)  # scenes whose poses need bbox normalization
RTMV_BBOX_ENLARGE = 1.05
