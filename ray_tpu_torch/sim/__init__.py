"""In-process cluster simulator: the control plane at 10k nodes.

SCALING_r05 measured the host, not the architecture — real agents
contend for 1.5 cores long before the drain/autoscaler/recovery
machinery is stressed.  This package runs the control-plane state
machines (head, node, autoscaler) single-process behind the two seams
the rest of the tree now honors:

- ``common/clock.py`` — a ``VirtualClock`` advances event-by-event, so
  heartbeat periods, lease timeouts, breaker cooldowns and drain
  deadlines are exact virtual quantities with no wall-clock sleeps;
- ``rpc/transport.py`` — ``SimTransport`` resolves ``sim://`` addresses
  to in-process handler tables, with every message routed through the
  chaos plane's per-link Philox streams (``_Chaos.link_action``), so a
  campaign's drop/dup/delay/partition schedule replays bit-for-bit from
  its seed.

``campaign.py`` scripts the failure campaigns (rolling kills, asymmetric
partitions, gray-slow links, drain-under-churn, autoscaler flapping),
checks invariants after every injected event, and emits a replayable
trace artifact keyed by seed (``ray_tpu_torch simulate``).

``hunt.py`` + ``minimize.py`` turn the same determinism into a search
engine (``ray_tpu_torch hunt``): fault schedules become serializable genomes,
a seeded mutator explores them guided by trace-derived coverage, and
every invariant violation is ddmin-minimized to a 1-minimal replayable
finding artifact.
"""

from .campaign import CAMPAIGNS, CampaignResult, run_campaign
from .cluster import SimCluster, SimParams
from .hunt import Genome, HuntResult, hunt
from .transport import SimTransport

__all__ = ["SimTransport", "SimCluster", "SimParams", "run_campaign",
           "CAMPAIGNS", "CampaignResult", "Genome", "HuntResult",
           "hunt"]
