from .flash_attention import flash_attention, flash_attention_plain
from .hybrid_kernel import (schedule_grouped, schedule_grouped_np,
                            waterfill_scan, waterfill_scan_plain)

__all__ = ["schedule_grouped", "schedule_grouped_np", "waterfill_scan",
           "waterfill_scan_plain", "flash_attention",
           "flash_attention_plain"]
