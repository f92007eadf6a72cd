"""Device ms a traced step spends in the dropless MoE's `models.moe.experts`
spans (the three grouped expert GEMMs and the SwiGLU between them), in the
forward pass and in its recomputation, between each span's two CUDA events.
None where the program records no such span."""
from perfbench import spans

LAYER = "models"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
NAMES = ("models.moe.experts",)


def read(rec):
    return value(spans.program_spans())


def value(xs):
    if not any(s["name"] in NAMES for s in xs):
        return None
    return spans.device_ms(xs, *NAMES)
