from .broadcast_kernel import plan_fanout, plan_fanout_np, plan_fanout_oracle
from .bundle_kernel import (schedule_bundle_groups, schedule_bundle_groups_np,
                            schedule_bundle_groups_oracle)
from .flash_attention import flash_attention, flash_attention_plain
from .hybrid_kernel import (schedule_grouped, schedule_grouped_np,
                            waterfill_scan, waterfill_scan_plain)
from .locality_kernel import (schedule_grouped_localized,
                              schedule_grouped_localized_np)
from .pull_kernel import (choose_sources, choose_sources_np,
                          choose_sources_oracle)

__all__ = ["schedule_bundle_groups", "schedule_bundle_groups_np",
           "schedule_bundle_groups_oracle",
           "schedule_grouped", "schedule_grouped_np", "waterfill_scan",
           "waterfill_scan_plain", "schedule_grouped_localized",
           "schedule_grouped_localized_np",
           "choose_sources", "choose_sources_np", "choose_sources_oracle",
           "plan_fanout", "plan_fanout_np", "plan_fanout_oracle",
           "flash_attention", "flash_attention_plain"]
