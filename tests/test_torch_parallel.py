"""Data and tensor parallelism of the port (``dphubert_torch/parallel/``) on
the CPU: gloo process groups of at most 4 ranks (``dphubert_torch.parallel.dryrun``'s
harness: each rank a process with its own time limit, rendezvous through a
``FileStore`` under ``tmp_path``), tiny models.

* the tensor-parallel split against the TPU package's ``param_shardings``,
  and the head-granular difference (a layer whose heads do not divide runs
  replicated);
* the dropout of a shard: the folded kernel seed and the global-shape
  activation draw give exactly the one-process mask's block;
* a (2 data x 2 model) step with attention and activation dropout on
  against the one-process step (HuBERT and DPWavLM; DPWavLM also at (2 x 1)
  and (1 x 2)), and against the TPU package's step on a (data 2, model 2)
  mesh of the 8 virtual devices (dropout off, the TPU step's gate draws
  injected): loss within 1e-5, every gathered parameter within 2e-5 after
  3 steps; DPWavLM's table and GRU gradients at (1 x 2) against one
  process's;
* ``steps_per_call=2`` on two ranks bit for bit K = 1;
* the loader's ``shard`` bit for bit the TPU package's;
* checkpoints in the one-card format: saved at (2 x 2), resumed at (1 x 1)
  and at (2 x 1);
* the CPU dry runs ``python -m dphubert_torch.parallel.dryrun``.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.models.components import Shard, WavLMSelfAttention, _dropout
from dphubert_torch.ops.attention_common import fold_dropout_seed, keep_mask
from dphubert_torch.ops.flash_attention import flash_attention_reference
from dphubert_torch.ops.packed_attention import packed_attention_reference
from dphubert_torch.ops.wavlm_attention import wavlm_attention_reference
from dphubert_torch.parallel.multihost import process_row_slice
from dphubert_torch.parallel.sharding import split_dims
from dphubert_torch.train import DistillConfig
from dphubert_torch.train.distill_module import refuse_gloo_graphs
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.train import distill_module as j_dm

from tests.test_forward_parity import _tiny_w2v2_config, _tiny_wavlm_config
from tests.test_torch_gates import PRUNE_FLAGS, jax_gate_draws, one_torch_thread  # noqa: F401
from tests.torch_parallel_worker import ENTRY, run_grads
from dphubert_torch.parallel.dryrun import check_ranks, run_steps, run_train, spawn

REPO = pathlib.Path(__file__).resolve().parents[1]
DROPOUT = dict(encoder_projection_dropout=0.1, encoder_attention_dropout=0.1,
               encoder_ff_interm_dropout=0.1, encoder_dropout=0.1)
DISTILL = dict(distill_layer_groups=((0,), (1, 3)), warmup_updates=2, max_updates=10,
               sparsity_warmup_updates=2, target_sparsity=0.5)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
RANK_TIMEOUT_S = 120


def _waves(n, seed, B=4, T=4000):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T)).astype(np.float32) for _ in range(n)]


def _steps_payload(family="hubert", **over):
    tiny = _tiny_w2v2_config if family == "hubert" else _tiny_wavlm_config
    return {**dict(teacher=tiny(), student=tiny(**PRUNE_FLAGS, **DROPOUT), distill=DISTILL,
                   seed=3, waves=_waves(3, 0), device="cpu"), **over}


def _train_payload(exp_dir, **over):
    return dict(teacher=_tiny_w2v2_config(), student=_tiny_w2v2_config(**PRUNE_FLAGS, **DROPOUT),
                distill=dict(DISTILL, max_updates=4), batch=(4, 4000, 10), seed=5,
                exp_dir=str(exp_dir), device="cpu", **over)


def _spawn(tmp, jobs, world, layout):
    """``jobs`` in one gloo group of ``world`` ranks on the CPU (the tests'
    rank worker: the harness's jobs and ``grads``, ``load_state``); rank
    0's results."""
    outs, results = spawn("jobs", world, tmp / "spawn", {"jobs": jobs}, layout, entry=ENTRY,
                          device="cpu", timeout=RANK_TIMEOUT_S, cwd=REPO)
    check_ranks(results)
    return outs[0]


def _close(got: dict, want: dict, what: str) -> None:
    """Every step's loss within 1e-5 and every parameter within 2e-5."""
    if "metrics" in want:
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL,
                                       err_msg=f"{what}: step {i} loss")
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        assert got["params"][k].shape == w.shape, k
        np.testing.assert_allclose(np.asarray(got["params"][k]), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# the TPU package's step on a (data 2, model 2) mesh, dropout off
# ---------------------------------------------------------------------------


def jax_mesh_steps(family="hubert", layout=(2, 2), place=None):
    """Three steps of the TPU package's distill step of the tiny model on a
    (data, model) mesh of the virtual devices (``tests/test_multidevice.py``'s
    layouts; ``place(spec, mesh, teacher params, train params)`` -> both
    placed, by default the teacher replicated and the tensor-parallel
    layouts), recording each step's gate draws: the payload of the same
    steps for the port, the TPU step's losses and its parameters after the
    last step."""
    from dphubert_tpu.parallel.mesh import batch_sharding, create_mesh, replicate
    from dphubert_tpu.parallel.sharding import place_train_params

    n = layout[0] * layout[1]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    tiny = _tiny_w2v2_config if family == "hubert" else _tiny_wavlm_config
    cfg_t, cfg_s = tiny(), tiny(**PRUNE_FLAGS)
    jt, js = j_wav2vec2_model(**cfg_t), j_wav2vec2_model(**cfg_s)
    tp, sp = jt.init(jax.random.key(0)), js.init(jax.random.key(1))
    dcfg = j_dm.DistillConfig(**DISTILL)
    state, tx = j_dm.init_train_state(student=js, student_params=sp, cfg=dcfg,
                                      teacher_embed_dim=64, rng=jax.random.key(42))
    start = pt.train_params_from_jax(jax.tree.map(np.asarray, state.params))
    mesh = create_mesh(n_data=layout[0], n_model=layout[1], devices=jax.devices()[:n])
    if place is None:
        teacher, params = replicate(mesh, tp), place_train_params(js.spec, mesh, state.params)
    else:
        teacher, params = place(js.spec, mesh, tp, state.params)
    state = state._replace(params=params, opt_state=tx.init(params))
    fn = j_dm.make_train_step(jt, js, dcfg, tx, donate=False)
    spec = pt.spec_from_config(**cfg_s)
    waves, gate_u, losses = _waves(3, 7), [], []
    for w in waves:
        _, gate_key, _ = jax.random.split(state.rng, 3)
        gate_u.append(jax_gate_draws(spec, state.params["student"], gate_key))
        state, m = fn(state, teacher, (jax.device_put(w, batch_sharding(mesh)), None))
        losses.append({"loss": float(m["loss"])})
    payload = dict(teacher=cfg_t, student=cfg_s, teacher_state=pt.state_dict_from_jax(tp),
                   distill={k: getattr(dcfg, k) for k in DistillConfig.__dataclass_fields__},
                   params=start, gate_u=gate_u, waves=waves, device="cpu")
    want = {"metrics": losses,
            "params": pt.train_params_from_jax(jax.tree.map(np.asarray, state.params))}
    return payload, want


@pytest.fixture(scope="module")
def jax_mesh_run():
    """The TPU package's three steps of the tiny HuBERT on a (data 2, model
    2) mesh, dropout off (``jax_mesh_steps``)."""
    return jax_mesh_steps()


@pytest.fixture(scope="module")
def jax_wavlm_mesh_run():
    """The same for the tiny DPWavLM: its attention's heads, position-bias
    rows and GRU gate split by XLA over ``model``."""
    return jax_mesh_steps("wavlm")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, jax_mesh_run, jax_wavlm_mesh_run):
    """One group of 4 ranks as (2 data x 2 model): the dropout steps, the
    TPU-comparison steps, a 4-step trainer run and the same run stopped at
    step 2 (its checkpoint); DPWavLM's dropout steps and TPU-comparison
    steps."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    jobs = {"dropout": ("steps", _steps_payload()),
            "jax": ("steps", jax_mesh_run[0]),
            "full": ("train", _train_payload(tmp / "full")),
            "half": ("train", _train_payload(tmp / "half", stop_at_step=2)),
            "wavlm_tp": ("steps", _steps_payload("wavlm")),
            "wavlm_jax": ("steps", jax_wavlm_mesh_run[0])}
    return tmp, _spawn(tmp, jobs, 4, (2, 2))


def _wavlm_grads_payload():
    return _steps_payload("wavlm", waves=_waves(1, 2))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, four_ranks):
    """One group of 2 ranks as (2 data x 1 model): DPWavLM's dropout steps,
    4 steps at K = 1 and at K = 2, and the (2 x 2) checkpoint resumed; then
    as (1 data x 2 model): DPWavLM's dropout steps and one step's
    gradients."""
    tmp4, _ = four_ranks
    tmp = tmp_path_factory.mktemp("two_ranks")
    k_steps = _steps_payload(waves=_waves(4, 1))
    jobs = {"wavlm": ("steps", _steps_payload("wavlm")),
            "k1": ("steps", k_steps),
            "k2": ("steps", dict(k_steps, steps_per_call=2)),
            "resume": ("train", _train_payload(tmp / "resume",
                                               resume=str(tmp4 / "half" / "ckpts" / "last.pt"))),
            "wavlm_1x2": ("steps", dict(_steps_payload("wavlm"), layout=(1, 2))),
            "wavlm_grads_1x2": ("grads", dict(_wavlm_grads_payload(), layout=(1, 2)))}
    return tmp, _spawn(tmp, jobs, 2, (2, 1))


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def _jax_split_dims(cfg, n_model):
    from jax.sharding import PartitionSpec as P

    from dphubert_tpu.parallel.mesh import create_mesh
    from dphubert_tpu.parallel.sharding import param_shardings
    from dphubert_tpu.params import flatten_params as j_flatten

    jm = j_wav2vec2_model(**cfg)
    params = jax.eval_shape(jm.init, jax.random.key(0))
    mesh = create_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    flat = j_flatten(param_shardings(jm.spec, mesh, params))
    out = {}
    for name, sh in flat.items():
        spec = tuple(sh.spec) + (None,) * 2
        out[name] = None if sh.spec == P() else spec.index("model")
    return out


@pytest.mark.parametrize("n_model", [2, 4])
def test_split_dims_match_the_tpu_param_shardings(n_model):
    """On the tiny gated model (4 heads x 16, 128 units) the port splits
    exactly the leaves the TPU package splits, along the same dims."""
    cfg = _tiny_w2v2_config(**PRUNE_FLAGS)
    want = _jax_split_dims(cfg, n_model)
    spec = pt.spec_from_config(**cfg)
    names = pt.wav2vec2_model(device="cpu", **cfg).state_dict().keys()
    got = split_dims(spec, names, n_model)
    assert set(got) == set(want)
    assert got == want
    assert sum(d is not None for d in got.values()) == 3 * 10


def test_a_layer_whose_heads_do_not_divide_runs_replicated():
    """A pruned student with 4, 3 and 2 heads and 128, 96 and 51 units at
    M = 2: the TPU rule splits layer 1's 48 q/k/v rows (1.5 heads a shard),
    the port keeps that attention whole on every model rank; layer 2's 51
    units stay whole in both; everything else is split alike."""
    cfg = _tiny_w2v2_config(encoder_num_heads=[4, 3, 2], encoder_ff_interm_features=[128, 96, 51])
    want = _jax_split_dims(cfg, 2)
    got = split_dims(pt.spec_from_config(**cfg), want, 2)
    differ = {k for k in want if got[k] != want[k]}
    layer1 = "encoder.transformer.layers.1.attention."
    assert differ == {layer1 + f"{p}.{w}" for p in ("q_proj", "k_proj", "v_proj")
                      for w in ("weight", "bias")} | {layer1 + "out_proj.weight"}
    assert all(got[k] is None for k in differ)
    assert got["encoder.transformer.layers.2.feed_forward.intermediate_dense.weight"] is None
    assert got["encoder.transformer.layers.1.feed_forward.intermediate_dense.weight"] == 0


# ---------------------------------------------------------------------------
# dropout of a shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b_off,h_off", [(0, 0), (2, 0), (0, 2), (2, 2), (1, 3)])
def test_folded_seed_gives_the_global_masks_block(b_off, h_off):
    """``fold_dropout_seed`` + a local ``keep_mask`` (the plain version of
    the kernels' hash) is the global mask's block bit for bit."""
    seed = torch.tensor([-1234567], dtype=torch.int32)
    B, H, L = 4, 6, 11
    full = keep_mask(seed, 0.1, B, H, L, "cpu")
    local = keep_mask(fold_dropout_seed(seed, b_off, h_off), 0.1, 2, 3, L, "cpu")
    assert torch.equal(local, full[b_off:b_off + 2, h_off:h_off + 3])
    assert fold_dropout_seed(seed, 0, 0) is seed


@pytest.mark.parametrize("kernel", ["packed", "flash", "wavlm"])
def test_plain_attention_on_a_shard_is_the_block_of_the_whole(kernel):
    """Each attention kernel's plain version with dropout, called on rows
    2-3 and heads 2-4 of a (4, 6)-head batch with the folded seed, returns
    that block of the one-call output: the same units are dropped."""
    g = torch.Generator().manual_seed(0)
    B, H, L, D, rate = 4, 6, 13, 8, 0.3
    q, k, v = (torch.randn(B, H, L, D, generator=g, dtype=torch.float64) for _ in range(3))
    seed = torch.tensor([987654321], dtype=torch.int32)
    rows, heads = slice(2, 4), slice(2, 5)
    local_seed = fold_dropout_seed(seed, 2, 2)
    kw = dict(dropout_rate=rate)

    def packed(t):  # (B, H, L, D) -> (B, L, H*D)
        return t.transpose(1, 2).reshape(t.shape[0], L, -1)

    if kernel == "packed":
        whole = packed_attention_reference(packed(q), packed(k), packed(v), num_heads=H,
                                           seed=seed, **kw).view(B, L, H, D).transpose(1, 2)
        qs, ks, vs = (packed(t[rows, heads]) for t in (q, k, v))
        part = packed_attention_reference(qs, ks, vs, num_heads=3, seed=local_seed,
                                          **kw).view(2, L, 3, D).transpose(1, 2)
    elif kernel == "flash":
        whole = flash_attention_reference(q, k, v, seed=seed, **kw)[0]
        part = flash_attention_reference(q[rows, heads], k[rows, heads], v[rows, heads],
                                         seed=local_seed, **kw)[0]
    else:
        bias = torch.randn(H, L, L, generator=g, dtype=torch.float64)
        gate = torch.rand(B, H, L, generator=g, dtype=torch.float64)
        whole = wavlm_attention_reference(q, k, v, bias, gate, seed=seed, **kw)[0]
        part = wavlm_attention_reference(q[rows, heads], k[rows, heads], v[rows, heads],
                                         bias[heads], gate[rows, heads], seed=local_seed,
                                         **kw)[0]
        no_fold = wavlm_attention_reference(q[rows, heads], k[rows, heads], v[rows, heads],
                                            bias[heads], gate[rows, heads], seed=seed, **kw)[0]
        assert not torch.allclose(no_fold, whole[rows, heads])  # the fold matters
    torch.testing.assert_close(part, whole[rows, heads], rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_data,cols", [(2, None), (4, None), (2, (16, 48)), (1, (0, 48))])
def test_activation_dropout_of_a_shard_is_the_global_masks_block(n_data, cols):
    """``_dropout`` on rows of data rank 1 (and a block of a split last
    dimension) equals that block of the one-process dropout drawn from the
    same generator state, and leaves the generator where the one-process
    draw does."""
    B, L, E = 2, 5, 48
    x = torch.randn(B * n_data, L, E, generator=torch.Generator().manual_seed(1))
    g_full, g_part = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    whole = _dropout(x, 0.3, g_full)
    rows = slice(B, 2 * B) if n_data > 1 else slice(0, B * n_data)
    width = E if cols is None else 16
    col = slice(0, E) if cols is None else slice(cols[0], cols[0] + width)
    shard = Shard(data_rank=1 if n_data > 1 else 0, n_data=n_data)
    part = _dropout(x[rows][..., col].contiguous(), 0.3, g_part, shard, cols)
    assert torch.equal(part, whole[rows][..., col])
    assert torch.equal(g_full.get_state(), g_part.get_state())


# ---------------------------------------------------------------------------
# steps on a mesh
# ---------------------------------------------------------------------------


def test_two_by_two_step_with_dropout_matches_one_process(four_ranks):
    """(2 data x 2 model), attention and activation dropout 0.1, gates from
    the shared generator: 3 steps within 1e-5 (loss) and 2e-5 (every
    gathered parameter) of the one-process steps."""
    _, out = four_ranks
    want = run_steps(_steps_payload())
    got = out["dropout"]
    _close(got, want, "(2 x 2) vs one process")
    assert torch.equal(got["generator"], want["generator"])  # the ranks drew in step
    assert len(got["shards"]) == 3 * 10  # q, k, v (w, b), out_proj w, FFN (w, b), (w)
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)


def test_dpwavlm_data_parallel_step_with_dropout_matches_one_process(two_ranks):
    """DPWavLM on (2 data x 1 model): the WavLM kernels' seeds folded by the
    data offset, dropout everywhere, within the same bounds."""
    _, out = two_ranks
    _close(out["wavlm"], run_steps(_steps_payload("wavlm")), "DPWavLM (2 x 1) vs one process")


@pytest.mark.parametrize("ranks,job,layout", [("four_ranks", "wavlm_tp", "(2 x 2)"),
                                              ("two_ranks", "wavlm_1x2", "(1 x 2)")])
def test_dpwavlm_tensor_parallel_step_with_dropout_matches_one_process(request, ranks, job,
                                                                       layout):
    """DPWavLM with its heads split over a model group of 2: each rank's 2
    heads take their rows of the position bias and the GRU gate, the
    kernels' seeds folded by the data and head offsets; dropout everywhere,
    3 steps within 1e-5 (loss) and 2e-5 (every gathered parameter) of one
    process, the generators in step."""
    _, out = request.getfixturevalue(ranks)
    got, want = out[job], run_steps(_steps_payload("wavlm"))
    _close(got, want, f"DPWavLM {layout} vs one process")
    assert torch.equal(got["generator"], want["generator"])
    att = [n for n, b in got["shards"].items() if ".attention." in n]
    assert len(att) == 3 * 7 and all(b.model_dim is not None for b in got["shards"].values())


def test_dpwavlm_two_by_two_step_matches_the_tpu_mesh_step(four_ranks, jax_wavlm_mesh_run):
    """DPWavLM's (2 x 2) step against the TPU package's on a (data 2, model
    2) mesh of virtual devices (XLA splits the bias and the gate there),
    dropout off, the TPU step's gate draws injected: 3 steps within 1e-5
    (loss) and 2e-5 (parameters)."""
    _, out = four_ranks
    _close(out["wavlm_jax"], jax_wavlm_mesh_run[1], "DPWavLM (2 x 2) vs the TPU mesh step")


def test_wavlm_table_and_gru_gradients_equal_one_process(two_ranks):
    """At (1 x 2) each rank's heads touch their own columns of the bucket
    table and rows of the GRU constant: after the *f* on the bias (once)
    and on the gate, the table's, the GRU linear's and the GRU constant's
    gradients equal one process's (within 1e-5 of each norm), in every
    layer; so does the loss."""
    _, out = two_ranks
    got, want = out["wavlm_grads_1x2"], run_grads(_wavlm_grads_payload())
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL)
    names = [n for n in want["grads"] if "rel_attn_embed" in n or "gru_rel_pos" in n]
    assert len(names) == 1 + 3 * 3  # the table; each layer's linear (w, b) and constant
    for n in names:
        g, w = got["grads"][n], want["grads"][n]
        assert w.norm() > 0, n
        assert (g - w).norm() <= 1e-5 * w.norm(), n


def test_two_by_two_step_matches_the_tpu_mesh_step(four_ranks, jax_mesh_run):
    """The port's (2 x 2) step against the TPU package's on a (data 2, model
    2) mesh of virtual devices, dropout off, the TPU step's gate draws
    injected: 3 steps within 1e-5 (loss) and 2e-5 (parameters)."""
    _, out = four_ranks
    _close(out["jax"], jax_mesh_run[1], "(2 x 2) vs the TPU (data 2, model 2) step")


def test_two_ranks_steps_per_call_two_is_bit_for_bit_one(two_ranks):
    _, out = two_ranks
    k1, k2 = out["k1"], out["k2"]
    assert k1["step"] == k2["step"] == 4
    assert k1["metrics"] == k2["metrics"]
    assert torch.equal(k1["generator"], k2["generator"])
    for k, v in k1["params"].items():
        assert torch.equal(k2["params"][k], v), k


def test_gloo_graphs_and_wavlm_tensor_parallel_are_refused():
    """K > 1 on the card over gloo is refused (its collectives cannot be
    captured).  WavLM under tensor parallelism no longer is: its test is
    ``test_wavlm_set_shard_splits_heads_and_their_bias_rows``."""

    class GlooMesh:
        def backend(self, group=None):
            return "gloo"

    with pytest.raises(ValueError, match="NCCL"):
        refuse_gloo_graphs(GlooMesh(), 2, "cuda")
    refuse_gloo_graphs(GlooMesh(), 1, "cuda")
    refuse_gloo_graphs(GlooMesh(), 2, "cpu")


@pytest.mark.parametrize("keep,rows", [(None, [2, 3]), ([0, 1, 3], None), ([1, 3], [3])])
def test_wavlm_set_shard_splits_heads_and_their_bias_rows(keep, rows):
    """``WavLMSelfAttention.set_shard`` over a model group of 2 gives model
    rank 1 the second half of the layer's heads and, as its bias and gate
    rows, those heads' rows: of all four (unpruned), or of the kept heads
    (pruned, ``remaining_heads``); 3 kept heads do not divide and the layer
    stays whole (``layer_splits``).  Data parallel leaves the rows whole."""
    from dphubert_torch.parallel.sharding import layer_splits

    over = {} if keep is None else {"encoder_remaining_heads": [keep] * 3}
    model = pt.wav2vec2_model(device="cpu", **_tiny_wavlm_config(**over))
    attention = model.encoder.transformer.layers[0].attention
    assert isinstance(attention, WavLMSelfAttention)
    split = layer_splits(model.spec, 2)[0][0]
    assert split == (rows is not None)
    attention.set_shard(Shard(model_rank=1, n_model=2), split)
    H = len(keep or range(4))
    if split:
        assert (attention.heads, attention.head_offset) == (H // 2, H // 2)
        assert attention._split_rows.tolist() == rows
    else:
        assert attention.heads == H and attention._split_rows is None
    attention.set_shard(Shard(data_rank=1, n_data=2), False)
    assert attention.heads == H and attention._split_rows is None


def test_process_row_slice():
    assert process_row_slice(1, 4, 16) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        process_row_slice(0, 3, 16)


# ---------------------------------------------------------------------------
# the loader's shard
# ---------------------------------------------------------------------------


def test_loader_shard_is_bit_for_bit_the_tpu_loaders():
    """``DistillDataLoader(shard=(p, 2))`` over a batcher of two replicas:
    every batch of an epoch, random crops included, equals the TPU
    package's loader's bit for bit."""
    from dphubert_torch.data.loader import DistillDataLoader
    from dphubert_torch.data.sampler import StaticShapeBatcher
    from dphubert_tpu.data.loader import DistillDataLoader as JLoader
    from dphubert_tpu.data.sampler import StaticShapeBatcher as JBatcher

    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(32000, 60000, 64)]

    class Stub:
        def __init__(self):
            self.waves = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
                          for i, n in enumerate(lengths)]

        def __len__(self):
            return len(self.waves)

        def load(self, i):
            return self.waves[i]

    ds = Stub()
    kw = dict(max_token_count=160000, min_len=32000, max_len=64000, num_shapes=2, seed=3,
              num_replicas=2)
    batches = 0
    for p in (0, 1):
        got = DistillDataLoader(ds, StaticShapeBatcher(lengths, **kw), num_workers=0, seed=5,
                                shard=(p, 2), feed_dtype="int16")
        want = JLoader(ds, JBatcher(lengths, **kw), num_workers=0, seed=5, shard=(p, 2),
                       feed_dtype="int16")
        for (g, _), (w, _) in zip(got.epoch(1), want.epoch(1), strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)
            batches += 1
    assert batches >= 4


# ---------------------------------------------------------------------------
# checkpoints at another layout
# ---------------------------------------------------------------------------


def test_checkpoint_is_one_card_and_resumes_at_other_layouts(four_ranks, two_ranks, tmp_path):
    """A (2 x 2) run stopped at step 2 writes the one-card state (every
    tensor at the one-process shape, its layout recorded); resumed to step 4
    at (1 x 1) in this process and at (2 x 1) on two ranks, both end within
    2e-5 of the uninterrupted (2 x 2) run."""
    tmp4, out4 = four_ranks
    _, out2 = two_ranks
    ckpt = torch.load(tmp4 / "half" / "ckpts" / "last.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["meta"]["layout"] == [2, 2]
    assert out4["half"]["why"] == "stop_at_step"
    full = out4["full"]
    for group in ("params",):
        for k, v in ckpt[group].items():
            assert v.shape == full["params"][k].shape, k
    for k, v in ckpt["opt"]["mu"].items():
        assert v.shape == full["params"][k].shape, k
    one = run_train(_train_payload(tmp_path / "one", resume=str(tmp4 / "half" / "ckpts" /
                                                                 "last.pt")))
    for name, got in (("(1 x 1)", one), ("(2 x 1)", out2["resume"])):
        assert got["step"] == full["step"] == 4
        _close(got, {"params": full["params"]}, f"resumed at {name}")


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,n", [("multichip", 4), ("multihost", 2)])
def test_dryrun(mode, n):
    proc = subprocess.run([sys.executable, "-m", "dphubert_torch.parallel.dryrun", "--device",
                           "cpu", mode, str(n)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"dryrun_{mode}({n}): ok" in proc.stdout
