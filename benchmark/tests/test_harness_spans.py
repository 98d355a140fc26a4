"""The readers of the program's own spans: sums of a span's host rows, a
parent's self time less its children's rows (a child clipped at a marker
too), the timed boundaries' totals, and None, never 0, where the slice or
the program holds no such span."""
from __future__ import annotations

import pytest

from benchmark.lib import cells, spans, trace
from benchmark.tests.conftest import ROOT

MARK = "at::cuda::spin_kernel(long)"


def _slice(host, device=(), wall=10.0, steps=2):
    sl = trace.Slice(device=list(device), host=list(host), wall_s=wall, start_s=0.0)
    sl.steps = steps
    return sl


def _read(name, sl):
    return cells.metric_reader(name).read(sl, None, name.partition(".")[2] or None)


# two iterations: waits, step calls and the loop's own time between them
HOST = [("vae/trainer.iter", 1.0, 3.0), ("vae/data.wait", 1.5, 0.5),
        ("vae/step.train", 2.0, 1.5), ("aten::copy_", 2.1, 0.2),
        ("vae/trainer.iter", 4.5, 3.0), ("vae/data.wait", 4.5, 1.0),
        ("vae/step.train", 5.5, 1.0), ("vae/checkpoint.save", 6.75, 0.5)]


def test_total_sums_the_rows_of_one_span():
    sl = _slice(HOST)
    assert spans.total_s(sl, "data.wait") == pytest.approx(1.5)
    assert spans.total_s(sl, "step.train") == pytest.approx(2.5)
    assert spans.total_s(sl, "trainer.iter") == pytest.approx(6.0)


def test_self_time_is_the_parent_less_its_children():
    sl = _slice(HOST)
    children = ("data.wait", "step.train", "step.eval", "checkpoint.save")
    # 3 - (0.5 + 1.5), then 3 - (1 + 1 + 0.5)
    assert spans.self_s(sl, "trainer.iter", children) == pytest.approx(1.5)
    assert spans.self_s(sl, "trainer.iter", ()) == pytest.approx(6.0)
    parts = sum(spans.total_s(sl, c) or 0.0 for c in children)
    assert parts + spans.self_s(sl, "trainer.iter", children) == pytest.approx(
        spans.total_s(sl, "trainer.iter"))


def test_overlapping_children_are_counted_once():
    sl = _slice([("vae/p", 0.0, 4.0), ("vae/a", 0.5, 2.0), ("vae/b", 1.5, 2.0),
                 ("vae/a", 5.0, 1.0)])
    assert spans.self_s(sl, "p", ("a", "b")) == pytest.approx(1.0)  # 4 - (3.5 - 0.5)


def test_a_child_clipped_at_a_marker_leaves_the_rest_of_its_parent():
    """The slice starts at the first marker, inside an iteration and inside
    its wait: both are clipped there, and the self time is what lies between
    the marker and the step call."""
    whole = trace.Slice(
        device=[(MARK, 2.0, 1e-6), ("conv", 2.5, 3.0), (MARK, 8.0, 1e-6)],
        host=[("vae/trainer.iter", 0.0, 5.0), ("vae/data.wait", 1.0, 1.5),
              ("vae/step.train", 3.0, 1.0), ("vae/trainer.iter", 5.0, 4.0),
              ("vae/step.train", 5.5, 3.0)],
        wall_s=10.0, start_s=0.0)
    sl = trace.between_marks(whole)
    sl.steps = 2
    assert sl.host[1] == ("vae/data.wait", 2.0, 0.5)
    assert spans.total_s(sl, "data.wait") == pytest.approx(0.5)
    assert spans.total_s(sl, "step.train") == pytest.approx(3.5)  # 1 + 2.5 up to 8
    # the first iteration from 2 to 5 less 0.5 of waiting and 1 of stepping;
    # the second from 5 to 8 less 2.5
    assert spans.self_s(sl, "trainer.iter", ("data.wait", "step.train")) == pytest.approx(2.0)
    assert _read("trainer_self_ms_per_step.train", sl) == pytest.approx(1e3)


def test_the_readers_give_milliseconds_a_step():
    sl = _slice(HOST, steps=3)
    assert _read("data_wait_ms_per_step.train", sl) == pytest.approx(500.0)
    assert _read("step_host_ms_per_step.train", sl) == pytest.approx(2.5e3 / 3)
    assert _read("trainer_self_ms_per_step.train", sl) == pytest.approx(500.0)


@pytest.mark.parametrize("name", ["data_wait_ms_per_step.train", "step_host_ms_per_step.train",
                                  "trainer_self_ms_per_step.train"])
def test_a_span_reader_gives_none_where_the_span_is_absent(name):
    """A program without the spans (an older commit) reads None, never 0."""
    sl = _slice([("aten::copy_", 0.0, 1.0), ("cudaGraphLaunch", 1.0, 0.1)])
    assert _read(name, sl) is None
    assert spans.total_s(sl, "data.wait") is None
    assert spans.self_s(sl, "trainer.iter", ("data.wait",)) is None
    assert _read(name, _slice(HOST, steps=0)) is None


def test_the_timed_readers_read_the_programs_totals(monkeypatch):
    from vae_mdl_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "totals",
                        lambda: {"checkpoint.save": (4, 0.2), "capture": (2, 3.5)})
    sl = _slice(HOST)
    assert _read("checkpoint_ms_per_save.train", sl) == pytest.approx(50.0)
    assert _read("capture_s.train", sl) == pytest.approx(3.5)
    assert _read("capture_s.eval", sl) == pytest.approx(3.5)
    monkeypatch.setattr(tracing, "totals", lambda: {})
    for name in ("checkpoint_ms_per_save.train", "capture_s.train", "capture_s.eval"):
        assert _read(name, sl) is None


def test_the_timed_readers_give_none_without_the_programs_tracing(monkeypatch):
    """An older program has no ``utils.tracing``: the readers give None."""
    import sys

    monkeypatch.setitem(sys.modules, "vae_mdl_tpu_torch.utils.tracing", None)
    assert spans.timed_total("capture") is None
    assert _read("capture_s.train", _slice(HOST)) is None
    assert _read("checkpoint_ms_per_save.train", _slice(HOST)) is None


@pytest.mark.parametrize("workload,metrics", [
    ("model05-f32-train", {"data_wait_ms_per_step.train", "step_host_ms_per_step.train",
                           "trainer_self_ms_per_step.train", "checkpoint_ms_per_save.train",
                           "capture_s.train"}),
    ("biladder_celeba-bf16-train", {"data_wait_ms_per_step.train", "capture_s.train"}),
    ("model05-f32-eval5000", {"capture_s.eval"}),
])
def test_the_cells_load_their_span_metrics(workload, metrics):
    cell = cells.load(ROOT, workload)
    names = {m.name for m in cell.per_layer}
    assert metrics <= names
    assert ("capture_s.eval" in names) == ("eval" in workload)
