from .ess_check import ess_below, ess_below_plain
from .fused_gather import (resample_gather_split, resample_gather_split_plain,
                           resample_gather_split_u,
                           resample_gather_split_u_plain)
from .max_scan import max_scan, max_scan_plain
from .merge_count import merge_count, merge_count_plain
from .gather import (gather_cols, gather_cols_plain, gather_rows,
                     gather_rows_plain)

__all__ = ["ess_below", "ess_below_plain", "resample_gather_split",
           "resample_gather_split_plain", "resample_gather_split_u",
           "resample_gather_split_u_plain", "max_scan", "max_scan_plain",
           "merge_count", "merge_count_plain", "gather_cols",
           "gather_cols_plain", "gather_rows", "gather_rows_plain"]
