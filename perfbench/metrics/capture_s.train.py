"""Host time of the process's captures of training windows: the sum of
its ``capture.window.<steps>`` spans (``run/window.capture``: warm-up,
restore, generator registration and record; ``utils/spans.py``), in s.
None without such a span."""


def read(ctx):
    try:
        from ultra_pytorch_tpu_torch.utils import spans
    except ImportError:
        return None
    found = [s["ms"] for name, got in spans.snapshot()["spans"].items()
             if name.startswith("capture.window.")
             for s in got["samples"]]
    return sum(found) / 1e3 if found else None
