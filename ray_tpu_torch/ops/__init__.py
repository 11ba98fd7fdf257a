from .binpack_kernel import (autoscale, autoscale_np, autoscale_sharded_np,
                             binpack_launch_loop, launch_loop_plain)
from .broadcast_kernel import plan_fanout, plan_fanout_np, plan_fanout_oracle
from .bundle_kernel import (schedule_bundle_groups, schedule_bundle_groups_np,
                            schedule_bundle_groups_oracle)
from .flash_attention import flash_attention, flash_attention_plain
from .hybrid_kernel import (schedule_grouped, schedule_grouped_np,
                            schedule_grouped_sharded_np, waterfill_scan,
                            waterfill_scan_plain)
from .locality_kernel import (schedule_grouped_localized,
                              schedule_grouped_localized_np,
                              schedule_grouped_localized_sharded_np,
                              schedule_grouped_topk,
                              schedule_grouped_topk_np,
                              schedule_grouped_topk_sharded_np)
from .pull_kernel import (choose_sources, choose_sources_np,
                          choose_sources_oracle)
from .ring_attention import (full_attention, ring_attention,
                             ulysses_attention)
from .shard_reduce import build_mesh, plane_for, resolve_shards

__all__ = ["schedule_bundle_groups", "schedule_bundle_groups_np",
           "schedule_bundle_groups_oracle",
           "schedule_grouped", "schedule_grouped_np",
           "schedule_grouped_sharded_np", "waterfill_scan",
           "waterfill_scan_plain", "schedule_grouped_localized",
           "schedule_grouped_localized_np",
           "schedule_grouped_localized_sharded_np", "schedule_grouped_topk",
           "schedule_grouped_topk_np", "schedule_grouped_topk_sharded_np",
           "autoscale", "autoscale_np", "autoscale_sharded_np",
           "binpack_launch_loop", "launch_loop_plain",
           "choose_sources", "choose_sources_np", "choose_sources_oracle",
           "plan_fanout", "plan_fanout_np", "plan_fanout_oracle",
           "flash_attention", "flash_attention_plain", "full_attention",
           "ring_attention", "ulysses_attention",
           "build_mesh", "plane_for", "resolve_shards"]
