"""Hand-written Hopper kernels (csrc/*.cu), their wrappers and plain versions.

Each wrapper counts the calls that launch its kernel (an attribute of the
wrapper, added to only where it launches); `launch_counts` reads them all
and `reset_launch_counts` sets them to 0, in the calling process.
"""


def _counters():
    from . import adamw
    from . import causal_conv as cc
    from . import expert_mm as emm
    from . import flash_attention as fa
    from . import flash_decode as fd
    from . import ssd_scan as ssd
    # name -> (wrapper, attribute): the final-state SSD forward and the
    # Dv != D attention launches are counted among the launches too, and
    # AdamW's updated elements beside its update launches
    return {"flash_attention": (fa.flash_attention, "launches"),
            "flash_decode": (fd.flash_decode, "launches"),
            "ssd_scan": (ssd.ssd_scan, "launches"),
            "ssd_scan_bwd": (ssd._launch_bwd, "launches"),
            "flash_attention_bwd": (fa._launch_bwd, "launches"),
            "ssd_scan_final_state": (ssd.ssd_scan, "final_state_launches"),
            "flash_attention_mla": (fa.flash_attention, "mla_launches"),
            "flash_attention_bwd_mla": (fa._launch_bwd, "mla_launches"),
            "causal_conv": (cc.causal_conv_silu, "launches"),
            "causal_conv_bwd": (cc._launch_bwd, "launches"),
            "expert_mm": (emm.expert_mm, "launches"),
            "expert_mm_bwd": (emm._launch_bwd, "launches"),
            "adamw": (adamw.adamw_update, "launches"),
            "adamw_elems": (adamw.adamw_update, "elems")}


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
