"""Feature / target schema of the heterogeneous grain graph.

Node features (after gradient augmentation, the model input):
  grain: [x, y, z, area, extraV, cosx, sinx, cosz, sinz, span, darea]  (11)
  joint: [x, y, z, G, R, span, dx, dy]                                 (8)

Edge types: ('grain','push','joint'), ('joint','pull','grain'),
('joint','connect','joint'). Every junction has exactly three junction
neighbors and three grain neighbors.
"""

from __future__ import annotations

GRAIN_FEATURES = (
    "x", "y", "z", "area", "extraV", "cosx", "sinx", "cosz", "sinz", "span",
)
JOINT_FEATURES = ("x", "y", "z", "G", "R", "span")
GRAIN_GRAD_FEATURES = ("darea",)
JOINT_GRAD_FEATURES = ("dx", "dy")

GRAIN_DIM = len(GRAIN_FEATURES) + len(GRAIN_GRAD_FEATURES)  # 11
JOINT_DIM = len(JOINT_FEATURES) + len(JOINT_GRAD_FEATURES)  # 8

GRAIN_TARGETS = ("darea", "extraV")
JOINT_TARGETS = ("dx", "dy")

# Column indices used by the rollout feature-integration step.
GRAIN_AREA_COL = 3
GRAIN_EXTRAV_COL = 4
GRAIN_SPAN_COL = 9
GRAIN_DAREA_COL = 10
JOINT_SPAN_COL = 5
JOINT_DX_COL = 6  # columns 6:8 hold the previous-step joint displacement

TARGET_SCALING = {"grain": 20.0, "joint": 5.0}

EDGE_TYPES = (
    ("grain", "push", "joint"),
    ("joint", "pull", "grain"),
    ("joint", "connect", "joint"),
)

# Exact junction degrees.
JJ_DEGREE = 3   # junction -> junction neighbors ('connect')
JG_DEGREE = 3   # grain neighbors of each junction ('push' into the junction)

# Capacity for the ring of junctions around one grain ('pull' into the grain).
DEFAULT_GRAIN_RING = 16

EDGE_LEN_SENTINEL = -2.0
INDEX_SENTINEL = -1

EDGE_EVENT_INVALID = -100
SPAN_NORMALIZER = 120.0
