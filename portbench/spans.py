"""The arithmetic of the per-layer metrics that read the port's own spans
(``topo_audio_autoencoder_torch.utils.profiling``): the layers' names
marked inside the program, recorded only while a profiler runs, so only
over a ``--trace 1`` run's profiled steps, and the set-up spans, recorded
in every run's process.

Each function returns None where the program records no spans (a port
without the recorder, or no span of the name), and the harness then
leaves the metric out. The host times of the profiled steps include the
profiler's own cost per operator; set-up spans are not profiled.
"""

from __future__ import annotations

from . import counts

ROOT = "taa.train.step"


def recorded():
    """The port's span summary by name, or None where the port has no
    recorder."""
    from topo_audio_autoencoder_torch.utils import profiling

    summary = getattr(profiling, "span_summary", None)
    return summary()["spans"] if summary is not None else None


def host_ms_per_step(prefix: str, root: str = ROOT):
    """Inclusive host ms a step of the spans whose name starts with
    ``prefix`` (one name, or a family such as ``taa.loss.``), over the
    count of ``root`` spans."""
    spans = recorded()
    if not spans or root not in spans:
        return None
    hits = [entry["host_s"] for name, entry in spans.items() if name.startswith(prefix)]
    return 1e3 * sum(hits) / spans[root]["count"] if hits else None


def span_roofline(run, which: str, name: str, peak: str, root: str = ROOT):
    """100 x the least time of the step's ``which`` attention work over the
    device seconds a step of the span ``name`` (its CUDA event pairs); the
    bound is ``readers.roofline_share``'s."""
    spans = recorded()
    if not spans or root not in spans or name not in spans or which not in run.attention:
        return None
    device_s = spans[name]["device_s"]
    if not device_s:
        return None
    flops, nbytes = run.attention[which]
    bound, _ = counts.roofline_seconds(flops, nbytes, peak)
    return 100.0 * bound / (device_s / spans[root]["count"])


def setup_seconds(name: str):
    """Host seconds of the set-up span ``name`` in this process: 0.0 where
    the port records spans and none of the name ran."""
    spans = recorded()
    if spans is None:
        return None
    return spans.get(name, {}).get("host_s", 0.0)
