"""The whole harness on the CPU: tiny cells that exist only in a temporary
directory (new configuration, mix and cell files and ``BENCHMARK.json``
entries, no file of the benchmark edited) run through ``run.main`` with the
look for a chip skipped; ``correct`` holds for the program as it is and
comes out false with the timed path broken underneath, once for each fault
the cells can have, under the real cells' limits."""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest

from benchmark import run
from benchmark.tests import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]


def real_limits():
    lim = lambda cell: json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["limits"]
    return {"train": lim("hubert_base.distill"), "serve": lim("hubert_base.serve")}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.write_tree(tmp_path_factory.mktemp("bench"), limits=real_limits())


def run_cell(root, cell, seed=3_000_000_019):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", "0"], root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_cell_added_as_files_runs_and_is_correct(tree, cell):
    rc, res, err = run_cell(tree, cell)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    kind = tiny.CELLS[cell][2]
    want = {"train": {"train_audio_s_per_s", "train_peak_gib", "setup_s"},
            "serve": {"serve_audio_s_per_s", "serve_p95_ms", "setup_s"}}[kind]
    assert set(res["metrics"]) == want
    for name in res["checks"]:
        assert f"check {name}:" in err


def _unchanged(monkeypatch):
    from dphubert_torch.train.optim import DistillOptimizer

    def step(self, grads, state, params, scalars=None):
        return self.tick(state)  # the counters move, the state does not

    monkeypatch.setattr(DistillOptimizer, "step", step)


def _half_batch(monkeypatch):
    from dphubert_torch.train import distill_module

    whole = distill_module._batch

    def half(batch, dtype, device):
        wave, lengths = whole(batch, dtype, device)
        n = wave.shape[0] // 2
        return wave[:n], None if lengths is None else lengths[:n]

    monkeypatch.setattr(distill_module, "_batch", half)


def _altered(monkeypatch):
    from dphubert_torch.serve import Predictor

    extract = Predictor.extract

    def altered(self, waves):
        out = extract(self, waves)
        out[0] = out[0] + 0.1 * out[0].std()
        return out

    monkeypatch.setattr(Predictor, "extract", altered)


def _lost(monkeypatch):
    """Every request of the window fails (after the set-up's one pass over
    the pool): its answers never come."""
    from dphubert_torch.serve import Predictor

    extract, calls = Predictor.extract, [0]

    def lost(self, waves):
        calls[0] += 1
        if calls[0] > tiny.MIXES["tiny_serve"]["pool_requests"]:
            raise RuntimeError("lost")
        return extract(self, waves)

    monkeypatch.setattr(Predictor, "extract", lost)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_hubert.distill", _unchanged), ("tiny_hubert.distill", _half_batch),
    ("tiny_wavlm.distill", _unchanged), ("tiny_wavlm.distill", _half_batch),
    ("tiny_hubert.serve", _altered), ("tiny_wavlm.serve", _altered),
    ("tiny_hubert.serve", _lost),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(tree, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res, err = run_cell(tree, cell)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_cell_metrics_follow_the_manifest():
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(man, w["name"], "end_to_end")}
        per = run.cell_metrics(man, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert all(m["moves"] in e2e for m in per)
        for m in per:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


def test_a_metric_added_as_a_file_is_read(tmp_path):
    (tmp_path / "benchmark" / "metrics").mkdir(parents=True)
    (tmp_path / "benchmark" / "metrics" / "busy_ms.train.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.trace.busy_s\n")
    from benchmark.lib import trace as TR

    ctx = run.Context("c", "train", TR.Trace([("gemm", 0.0, 0.25)], [], 0.0, 1.0), 1.0, 1.0,
                      0.0, 1.0, [])
    assert run.read_metric(tmp_path, "busy_ms.train", ctx) == 250.0


def test_seeds_are_fixed_and_take_large_values():
    a, b = run.seeds(2**31 + 12345), run.seeds(2**31 + 12345)
    assert a == b and len(set(a.values())) == len(a)
    assert all(0 <= v < 2**63 for v in a.values())
    assert run.seeds(7) != a


def test_serve_feed_gives_every_seed_the_same_requests():
    from benchmark.drivers import serve

    mix = tiny.MIXES["tiny_serve"]
    got = [sorted(tuple(sorted(len(c) for c in r))
                  for r in serve.feed(mix, s, "cpu").requests) for s in (1, 2)]
    assert got[0] == got[1]
    a = serve.feed(mix, 1, "cpu").requests[0][0]
    b = serve.feed(mix, 2, "cpu").requests[0][0]
    assert not (len(a) == len(b) and np.array_equal(a, b))


SINGLE = """
from benchmark.drivers import serve


class Driver(serve.Driver):
    def make_feed(self):
        self.feed = serve.feed(self.mix, self.seeds["data"], self.device)
        self.feed.requests = [r[:1] for r in self.feed.requests]
"""


def test_a_traffic_kind_added_as_files_runs(tmp_path):
    """A new kind of mix (its driver, mix, cell and the manifest's entries)
    added as files under a tree of its own: one clip a request."""
    root = tiny.write_tree(tmp_path, limits=real_limits())
    b = root / "benchmark"
    (b / "drivers" / "single_clip.py").write_text(SINGLE)
    (b / "traffic" / "tiny_single.json").write_text(
        json.dumps(dict(tiny.MIXES["tiny_serve"], kind="single_clip")))
    (b / "workloads" / "tiny_hubert.single.json").write_text(json.dumps(
        {"config": "tiny_hubert", "traffic": "tiny_single", "limits": real_limits()["serve"]}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny_hubert.single", "config": "tiny_hubert",
                             "traffic": "tiny_single", "chips": 1, "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny_hubert.serve" in m.get("workloads", []):
            m["workloads"].append("tiny_hubert.single")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    rc, res, err = run_cell(root, "tiny_hubert.single")
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["serve_audio_s_per_s"]["value"] > 0
    assert res["readings"]["requests_checked"] == tiny.MIXES["tiny_serve"]["check_requests"]


def test_an_unknown_traffic_kind_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        run.driver_class(tiny.write_tree(tmp_path), "no_such_kind")


@pytest.mark.parametrize("mix", ["distill_ladder", "serve_short", "serve_long"])
def test_the_length_table_fits_its_published_mean(mix):
    """The table's mean (uniform within a bin) is the source's hours over
    its utterance count (LibriSpeech train-960: 960.9 h in 281,241
    utterances, 12.30 s)."""
    from benchmark.lib import traffic

    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    pub = m["assumed"]["length_table"]["published"]
    published = 3600 * sum(pub["hours"].values()) / sum(pub["utterances"].values())
    lo, hi, w = traffic.table(m)
    assert published == pytest.approx(12.30, abs=0.005)
    assert float((w * (lo + hi) / 2).sum()) == pytest.approx(published, abs=0.01)
