from .fused_gather import resample_gather_split, resample_gather_split_plain

__all__ = ["resample_gather_split", "resample_gather_split_plain"]
