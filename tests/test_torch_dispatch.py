"""``steps_per_dispatch`` in the port: K steps per call of
``make_train_step(..., steps_per_call=K)`` and the trainer's grouping.

On the CPU (these tests) a group is K eager steps, so K = 4 and K = 1 over
the same batches are the same arithmetic and must agree bit for bit; the
grouper is the TPU package's, input for input; the per-step scalars that a
graph reads from the card are the old host formulas bit for bit.  The
``gpu`` tests hold a replayed CUDA graph against eager steps on the card
(``python -m pytest --noconftest -m gpu tests/test_torch_dispatch.py``:
this module imports no JAX at the top).
"""

import json

import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.train import DistillConfig, init_train_state, make_train_step, train
from dphubert_torch.train import trainer as t_trainer
from dphubert_torch.train.checkpointing import load_train_state
from dphubert_torch.train.distill_module import GraphedSteps, step_scalars
from dphubert_torch.train.optim import B1, B2, GROUPS

PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)
DROPOUT = dict(encoder_projection_dropout=0.1, encoder_attention_dropout=0.1,
               encoder_ff_interm_dropout=0.1, encoder_dropout=0.1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(**over):
    """A 3-layer, 128-wide encoder (2 heads x 64, a head size the card's
    kernels take) on a small conv stack of the real 320-sample stride."""
    cfg = dict(
        extractor_mode="group_norm",
        extractor_conv_layer_config=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
        extractor_conv_bias=False, encoder_embed_dim=128, encoder_projection_dropout=0.0,
        encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4, encoder_num_layers=3,
        encoder_use_attention=[True] * 3, encoder_use_feed_forward=[True] * 3,
        encoder_num_heads=[2] * 3, encoder_head_dim=64, encoder_attention_dropout=0.0,
        encoder_ff_interm_features=[256] * 3, encoder_ff_interm_dropout=0.0,
        encoder_dropout=0.0, encoder_layer_norm_first=False, encoder_layer_drop=0.0,
        aux_num_out=None, normalize_waveform=False,
    )
    cfg.update(over)
    return cfg


def models(device="cpu"):
    """A teacher and a gated student with dropout on, from seeds."""
    teacher = pt.wav2vec2_model(device=device, generator=torch.Generator().manual_seed(0),
                                **tiny())
    student = pt.wav2vec2_model(device=device, generator=torch.Generator().manual_seed(1),
                                **tiny(**PRUNE_FLAGS, **DROPOUT))
    return teacher, student


def config(**over):
    kw = dict(distill_layer_groups=((0,), (1, 3)), warmup_updates=2, max_updates=6,
              sparsity_warmup_updates=2, target_sparsity=0.5, learning_rate=2e-3)
    kw.update(over)
    return DistillConfig(**kw)


class Batches:
    """``n`` batches an epoch of 2 x 3,200 samples (10 frames), drawn from
    the epoch's seed; every other epoch's batches carry lengths."""

    def __init__(self, n=12):
        self.n = n

    def epoch(self, e, skip=0):
        rng = np.random.default_rng(e)
        for i in range(self.n):
            wave = (0.1 * rng.standard_normal((2, 3200))).astype(np.float32)
            lengths = np.array([3200, 2600], np.int32) if e % 2 else None
            if i >= skip:
                yield wave, lengths


def run(exp_dir, **kw):
    teacher, student = models()
    kw.setdefault("cfg", config())
    kw.setdefault("ckpt_interval", 100)
    return train(teacher=teacher, student=student, loader=kw.pop("loader", Batches()),
                 exp_dir=exp_dir, log_interval=1, device="cpu", **kw)


def metrics_rows(path):
    return [json.loads(line) for line in open(path)]


def assert_same_state(a, b):
    for (k, x), (_, y) in zip(a.named_params().items(), b.named_params().items()):
        assert torch.equal(x, y), k
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k
    assert (a.step, a.opt_state.count, a.opt_state.mini_step) == (
        b.step, b.opt_state.count, b.opt_state.mini_step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("accum_grad,remat", [(1, False), (2, False), (1, True)],
                         ids=["1", "2", "1-remat"])
def test_four_steps_a_dispatch_match_single_steps(tmp_path, accum_grad, remat):
    """K = 4 against K = 1 over the same batches (gates and dropout on):
    9 micro-steps (accum_grad 1) or 14 (accum_grad 2: 7 updates, into the
    next epoch, whose batches carry lengths), so groups form and the last
    prefetched group overshoots and runs as single steps; every logged
    metric, parameter, moment and the generator equal bit for bit; also
    with the student's layers checkpointed (``remat``)."""
    cfg = config(max_updates=9 if accum_grad == 1 else 7, accum_grad=accum_grad, remat=remat)
    one = run(tmp_path / "k1", cfg=cfg)
    four = run(tmp_path / "k4", cfg=cfg, steps_per_dispatch=4)
    assert one.step == four.step == cfg.max_updates * accum_grad
    assert_same_state(one, four)
    rows1 = metrics_rows(tmp_path / "k1" / "metrics.jsonl")
    rows4 = metrics_rows(tmp_path / "k4" / "metrics.jsonl")
    assert [r["step"] for r in rows4] == [r["step"] for r in rows1] == list(
        range(1, one.step + 1))
    for a, b in zip(rows1, rows4):
        for key in ("loss", "loss_reg", "grad_norm", "lambda1", "sparsity_target", "updates"):
            assert a[key] == b[key], (a["step"], key)


def test_dispatch_stops_exactly_at_max_updates(tmp_path):
    """K = 4 with max_updates = 6: the prefetched second group holds steps
    5-8, and only 2 of it are taken; the checkpoint counts exactly the 6
    batches consumed."""
    state = run(tmp_path, steps_per_dispatch=4)
    assert state.step == 6
    ckpt = torch.load(tmp_path / "ckpts" / "last.pt", weights_only=True)
    assert (ckpt["epoch"], ckpt["batch_in_epoch"], ckpt["step"]) == (0, 6, 6)
    assert ckpt["meta"]["steps_per_dispatch"] == 4


def test_dispatch_resume_positions_and_refused_k(tmp_path):
    """K = 2 stopped at step 3 checkpoints on the dispatch boundary, step 4
    (batch 4 of epoch 0), and resumes to the end equal to the uninterrupted
    K = 2 run bit for bit; the same checkpoint under K = 1 is refused."""
    full = run(tmp_path / "full", steps_per_dispatch=2)
    stop_info = {}
    part = run(tmp_path / "part", steps_per_dispatch=2, stop_at_step=3, stop_info=stop_info)
    assert stop_info["why"] == "stop_at_step" and part.step == 4
    last = tmp_path / "part" / "ckpts" / "last.pt"
    ckpt = torch.load(last, weights_only=True)
    assert (ckpt["epoch"], ckpt["batch_in_epoch"]) == (0, 4)
    resumed = run(tmp_path / "part", steps_per_dispatch=2, resume=last)
    assert resumed.step == full.step == 6
    assert_same_state(full, resumed)
    with pytest.raises(ValueError, match="steps_per_dispatch=2"):
        run(tmp_path / "other", resume=last)


def test_group_iter_groups_as_the_tpu_package():
    """The port's copy of ``_group_iter`` against the TPU package's on one
    stream: runs of one shape, a shape change mid-run, lengths appearing,
    an epoch tail, and ``remaining()`` running out."""
    from dphubert_tpu.train.trainer import _group_iter as j_group_iter

    rng = np.random.default_rng(3)
    stream = []
    for shape, with_len, n in (((2, 320), False, 5), ((3, 640), False, 2),
                               ((3, 640), True, 4), ((2, 320), True, 7)):
        for _ in range(n):
            lengths = rng.integers(1, shape[1], shape[0]).astype(np.int32) if with_len else None
            stream.append((rng.standard_normal(shape).astype(np.float32), lengths))
    for k in (1, 2, 4):
        for budget in (100, 9):
            left = {"port": budget, "tpu": budget}

            def take(which, it):
                for wave, lengths in it:
                    left[which] -= wave.shape[0] if wave.ndim == 3 else 1
                    yield wave, lengths

            got = list(take("port", t_trainer._group_iter(iter(stream), k,
                                                          lambda: left["port"])))
            want = list(take("tpu", j_group_iter(iter(stream), k, lambda: left["tpu"])))
            assert len(got) == len(want), (k, budget)
            for (gw, gl), (ww, wl) in zip(got, want):
                np.testing.assert_array_equal(gw, ww)
                assert (gl is None) == (wl is None)
                if gl is not None:
                    np.testing.assert_array_equal(gl, wl)


def _old_scalars(cfg, step, count, base_lr, sign):
    """The host arithmetic the optimizer and the sparsity term used before
    the scalars moved to the card, written out."""
    upd = step // max(cfg.accum_grad, 1)
    frac = min(np.float32(upd) / np.float32(max(cfg.sparsity_warmup_updates, 1)),
               np.float32(1.0))
    target = float(np.float32(cfg.target_sparsity) * frac)
    count_inc = count + 1
    bc1 = float(1 - np.float32(B1) ** np.float32(count_inc))
    bc2 = float(1 - np.float32(B2) ** np.float32(count_inc))
    t = np.float32(count + 1)
    if t >= cfg.max_updates:
        factor = 0.0
    elif t <= cfg.warmup_updates:
        factor = float(t / np.float32(max(cfg.warmup_updates, 1)))
    else:
        factor = float((np.float32(cfg.max_updates) - t)
                       / np.float32(max(cfg.max_updates - cfg.warmup_updates, 1)))
    sizes = [float(np.float32(sign[g] * base_lr[g] * factor)) if g in base_lr else 0.0
             for g in GROUPS]
    return np.array([target, bc1, bc2, factor, *sizes], np.float32)


@pytest.mark.parametrize("use_reg,accum_grad", [(True, 1), (True, 3), (False, 1)])
def test_step_scalars_equal_the_old_host_formulas(use_reg, accum_grad):
    """Update counts 0-200 (every micro-step of them) with warm-up (50
    updates) and decay to 0 (at 150) crossed, and the sparsity target's warm-up (80): the sparsity target,
    both bias corrections, the schedule factor and every group's step size
    bit for bit the old host values; a K-step group's plan reads the same
    rows."""
    from dphubert_torch.train.distill_module import _plan

    cfg = config(use_reg=use_reg, accum_grad=accum_grad, warmup_updates=50, max_updates=150,
                 sparsity_warmup_updates=80, target_sparsity=0.75, learning_rate=2e-4,
                 reg_learning_rate=0.02)
    flags = PRUNE_FLAGS if use_reg else {}
    student = pt.wav2vec2_model(device="cpu", **tiny(**flags))
    state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, device="cpu")
    rows = []
    for step in range(201 * accum_grad):
        count = step // accum_grad
        got = step_scalars(cfg, tx, step, count)
        want = _old_scalars(cfg, step, count, tx.base_lr, tx.sign)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (step, got, want)
        rows.append(got)
    assert rows[0][3] > 0 and rows[-1][3] == 0.0 and rows[-1][0] == np.float32(0.75)
    state.step, state.opt_state.count, state.opt_state.mini_step = 60, 60 // accum_grad, 0
    plan = _plan(cfg, tx, state, 4)
    assert np.array_equal(plan.view(np.uint32), np.stack(rows[60:64]).view(np.uint32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path and the kernels run there")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def deterministic(monkeypatch):
    """cuDNN's deterministic algorithms: its default weight-gradient
    algorithms sum with atomics, so two eager runs differ in the last bits,
    and a graph could not be held to eager bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def _graph_against_eager(accum_grad, lengths, remat=False):
    """A 4-step group on the card: the first call of a key runs eagerly and
    captures, two replays follow; against 12 eager single steps from the
    same state and generator, every parameter, moment, the counters, the
    generator and the metrics equal bit for bit after each call (dropout
    and gates on), so the replays read each step's own scalars; returns
    the group."""
    _card()
    teacher, student = models("cuda")
    cfg = config(accum_grad=accum_grad, max_updates=20, remat=remat)
    a, tx_a = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, device="cuda")
    b, tx_b = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, device="cuda")
    single = make_train_step(teacher, cfg, tx_a)
    group = make_train_step(teacher, cfg, tx_b, steps_per_call=4)
    GraphedSteps.reset_tally()
    rng = np.random.default_rng(0)
    for call in range(3):
        waves = (0.1 * rng.standard_normal((4, 2, 3200))).astype(np.float32)
        lens = None if lengths is None else np.array([lengths] * 4, np.int32)
        want = []
        for j in range(4):
            a, m = single(a, (waves[j], None if lens is None else lens[j]))
            want.append(m)
        b, got = group(b, (waves, lens))
        torch.cuda.synchronize()
        assert_same_state(a, b)
        for k, v in got.items():
            assert torch.equal(v, torch.stack([m[k].float() for m in want])), (call, k)
    assert len(group.graphs) == 1
    # the tally: one capture's launches, run again by each of two replays
    captured = GraphedSteps.captured
    assert captured and captured.get("packed_attention_fwd", 0) > 0
    assert GraphedSteps.replays == 2
    assert GraphedSteps.replayed == {k: 2 * v for k, v in captured.items()}
    return group


@pytest.mark.gpu
@pytest.mark.parametrize("accum_grad,lengths", [(1, None), (2, [3200, 2600])])
def test_graph_replays_equal_eager_steps_on_card(accum_grad, lengths, deterministic):
    _graph_against_eager(accum_grad, lengths)


@pytest.mark.gpu
def test_graph_keys_share_one_pool_and_replay_in_turn_on_card(deterministic):
    """Three keys (two batch shapes, one of them with lengths too)
    captured into the one shared pool and replayed in turn, A B C A B C A
    B C: bit for bit the same 36 eager single steps, so no replay
    overwrites what another graph left live."""
    _card()
    teacher, student = models("cuda")
    cfg = config(max_updates=50)
    a, tx_a = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, device="cuda")
    b, tx_b = init_train_state(student=student, cfg=cfg, teacher_embed_dim=128, device="cuda")
    single = make_train_step(teacher, cfg, tx_a)
    group = make_train_step(teacher, cfg, tx_b, steps_per_call=4)
    rng = np.random.default_rng(1)
    shapes = [((4, 2, 3200), None), ((4, 3, 2240), None), ((4, 2, 3200), [3200, 2100])]
    for call in range(9):
        shape, lengths = shapes[call % 3]
        waves = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        lens = None if lengths is None else np.array([lengths] * 4, np.int32)
        want = []
        for j in range(4):
            a, m = single(a, (waves[j], None if lens is None else lens[j]))
            want.append(m)
        b, got = group(b, (waves, lens))
        torch.cuda.synchronize()
        assert_same_state(a, b)
        for k, v in got.items():
            assert torch.equal(v, torch.stack([m[k].float() for m in want])), (call, k)
    assert len(group.graphs) == 3


@pytest.mark.gpu
def test_trainer_dispatches_graphs_on_card_as_single_steps(tmp_path, deterministic):
    """The trainer on the card with K = 4 (groups replayed as graphs, the
    tail as single steps, background checkpoints every 4 steps, so a
    capture waits for a save in flight) against K = 1 over the same
    batches: the same state bit for bit, and the same rotated files."""
    def run_card(exp_dir, k):
        teacher, student = models("cuda")
        return train(teacher=teacher, student=student, loader=Batches(), exp_dir=exp_dir,
                     cfg=config(max_updates=14), log_interval=1, ckpt_interval=4,
                     steps_per_dispatch=k, ckpt_backend="rotated", ckpt_keep=2,
                     device="cuda")

    _card()
    one = run_card(tmp_path / "k1", 1)
    four = run_card(tmp_path / "k4", 4)
    assert one.step == four.step == 14
    assert_same_state(one, four)
    for exp in ("k1", "k4"):
        names = sorted(p.name for p in (tmp_path / exp / "ckpts" / "rotated").iterdir())
        assert names == ["step_12.pt", "step_14.pt"], (exp, names)


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [None, [3200, 2600]])
def test_remat_graph_replays_equal_eager_steps_on_card(lengths, deterministic):
    """The student's layers checkpointed inside the 4-step graph: each
    captured recompute draws its forward's dropout from a generator of its
    own (``RematReplay``, set before every replay), so two replays still
    equal 8 eager remat steps bit for bit; a forward a layer more is
    captured (the recompute), one generator registered for each of the
    group's 4 x 3 checkpointed layers."""
    group = _graph_against_eager(1, lengths, remat=True)
    (g,) = group.graphs.values()
    assert len(g.remat.states) == len(g.remat.offsets) == 12
    assert GraphedSteps.captured["packed_attention_fwd"] == 4 * (3 + 3 + 3)


def test_resume_under_another_k_reads_a_missing_record_as_one(tmp_path):
    """A checkpoint without ``steps_per_dispatch`` in its meta (written
    before K was recorded) resumes under K = 1 and is refused under K = 4."""
    state = run(tmp_path / "a", cfg=config(max_updates=2))
    last = tmp_path / "a" / "ckpts" / "last.pt"
    ckpt = torch.load(last, weights_only=True)
    del ckpt["meta"]["steps_per_dispatch"]
    old = tmp_path / "old.pt"
    torch.save(ckpt, old)
    fresh, _ = init_train_state(student=models()[1], cfg=config(max_updates=2),
                                teacher_embed_dim=128, device="cpu")
    assert load_train_state(old, fresh) == (0, 2)
    assert_same_state(state, fresh)
    with pytest.raises(ValueError, match="steps_per_dispatch=1"):
        load_train_state(old, fresh, steps_per_dispatch=4)
