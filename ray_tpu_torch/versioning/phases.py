"""Rollout state-machine phases, shared by the live controller
(``versioning/rollout.py``) and the simulator twin (``sim/rollout.py``)
so trace artifacts, invariants, and observability all speak one
vocabulary."""

STAGING = "STAGING"             # new version allocated, artifact pinned
BROADCASTING = "BROADCASTING"   # weights streaming 1->N down the tree
FLIPPING = "FLIPPING"           # replicas flipping one-at-a-time
SEALED = "SEALED"               # every replica on the new version
ROLLED_BACK = "ROLLED_BACK"     # failure: re-flipped to the old version
PAUSED = "PAUSED"               # operator hold between flips

TERMINAL = (SEALED, ROLLED_BACK)

# legal transitions; the registry refuses anything else so a buggy
# driver cannot journal an impossible history
NEXT = {
    STAGING: (BROADCASTING, ROLLED_BACK),
    BROADCASTING: (FLIPPING, ROLLED_BACK),
    FLIPPING: (PAUSED, SEALED, ROLLED_BACK),
    PAUSED: (FLIPPING, ROLLED_BACK),
    SEALED: (),
    ROLLED_BACK: (),
}
