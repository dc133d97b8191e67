"""FSDP and HSDP of the port (``dphubert_torch/parallel/fsdp.py``) on the
CPU: gloo process groups of 2 and 4 ranks (``dphubert_torch.parallel.dryrun``'s
harness and the tests' rank worker, a ``FileStore`` under ``tmp_path``, a
time limit each), tiny models split at ``min_size=1024`` so that they split
something (``tests/test_multidevice.py`` places the TPU package's steps so).

* the layout rule gives the dimension the TPU package's ``fsdp_spec`` gives,
  for every leaf of the tiny HuBERT and WavLM and of ``hubert_base`` and
  ``wav2vec2_large`` (shapes from ``jax.eval_shape``), with and without the
  model split;
* a (4 data x 1 model) FSDP step and a (2 x 2) HSDP step with dropout
  against one process, and against the TPU package's step placed by
  ``place_fsdp`` / ``place_train_params_fsdp`` (dropout off, its gate draws
  injected): loss within 1e-5, every gathered parameter within 2e-5 after 3
  steps; a split leaf holds 1/n_data of its elements on each rank, its Adam
  moments too;
* on 2 ranks with FSDP, K = 2 bit for bit K = 1, and ``remat`` within 1e-4
  of each gradient's norm of the step without it;
* checkpoints stay one-card: written at (2 x 1) FSDP and restored at one
  process, (1 x 2) and (2 x 2) HSDP bit for bit (and resumed to the end of
  the uninterrupted run within 2e-5), and written at one process, (1 x 2)
  and (2 x 2) HSDP and restored at FSDP bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.parallel.dryrun import run_steps, run_train
from dphubert_torch.parallel.fsdp import MIN_SHARD_ELEMS, fsdp_dim, fsdp_dims
from dphubert_torch.parallel.sharding import split_dims
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model

from tests.test_forward_parity import _tiny_w2v2_config, _tiny_wavlm_config
from tests.test_torch_gates import PRUNE_FLAGS, one_torch_thread  # noqa: F401
from tests.test_torch_parallel import (
    _close,
    _spawn,
    _steps_payload,
    _train_payload,
    _waves,
    jax_mesh_steps,
)
from tests.torch_parallel_worker import run_grads, run_load_state

MIN = 1024  # the tiny models' leaves split at this size, as the TPU tests place them
REMAT_GRAD_TOL = 1e-4


def _fsdp(payload, layout=None):
    out = dict(payload, fsdp=True, min_size=MIN)
    if layout is not None:
        out["layout"] = layout
    return out


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------


def _jax_fsdp_dims(jm, n_data, n_model, min_size):
    """The data-axis dimension the TPU package gives every leaf of ``jm``'s
    parameters (None: not split over data), with its tensor-parallel base
    at ``n_model`` > 1, from ``fsdp_spec`` on ``jax.eval_shape``'s shapes;
    and the leaves' shapes."""
    from dphubert_tpu.parallel.fsdp import fsdp_spec
    from dphubert_tpu.parallel.mesh import create_mesh
    from dphubert_tpu.parallel.sharding import param_shardings
    from dphubert_tpu.params import flatten_params as j_flatten

    tree = jax.eval_shape(jm.init, jax.random.key(0))
    shapes = {n: tuple(v.shape) for n, v in j_flatten(tree).items()}
    base = {}
    if n_model > 1:
        mesh = create_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
        base = {n: sh.spec for n, sh in j_flatten(param_shardings(jm.spec, mesh, tree)).items()}
    out = {}
    for name, shape in shapes.items():
        spec = tuple(fsdp_spec(shape, n_data, base=base.get(name), min_size=min_size))
        out[name] = spec.index("data") if "data" in spec else None
    return out, shapes


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("model", ["tiny_hubert", "tiny_wavlm", "hubert_base",
                                   "wav2vec2_large"])
def test_fsdp_dims_match_the_tpu_fsdp_spec(model, n_data, n_model):
    """Every leaf's data-split dimension is the TPU package's, with the
    model split first: the tiny models at ``min_size=1024``, the full-size
    ones at the default ``MIN_SHARD_ELEMS``."""
    import dphubert_tpu as jp

    if model.startswith("tiny"):
        cfg = (_tiny_w2v2_config if model == "tiny_hubert" else _tiny_wavlm_config)(**PRUNE_FLAGS)
        jm, spec, min_size = j_wav2vec2_model(**cfg), pt.spec_from_config(**cfg), MIN
    else:
        jm = getattr(jp, model)()
        spec, min_size = jm.spec, MIN_SHARD_ELEMS
    want, shapes = _jax_fsdp_dims(jm, n_data, n_model, min_size)
    got = fsdp_dims(shapes, n_data, split_dims(spec, shapes, n_model), min_size)
    assert got == want
    assert any(d is not None for d in got.values())


def test_fsdp_dim_cases_of_the_tpu_rule_test():
    """``tests/test_multidevice.py::test_fsdp_spec_rule``'s cases."""
    assert fsdp_dim((768, 768), 8, min_size=1024) == 0
    assert fsdp_dim((512, 256, 3), 8, min_size=1024) == 0
    assert fsdp_dim((768,), 8, min_size=1024) is None
    assert fsdp_dim((1023, 512), 8, min_size=1024) == 1
    assert fsdp_dim((768, 768), 8, taken=0, min_size=1024) == 1
    assert fsdp_dim((768, 1023), 8, taken=0, min_size=1024) is None
    assert fsdp_dim((768, 768), 1, min_size=1) is None  # nothing at n_data = 1


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _jax_fsdp_run(tensor_parallel):
    """The TPU package's steps at (data 4) FSDP or (data 2, model 2) HSDP,
    both placed at ``min_size=1024``."""
    from dphubert_tpu.parallel.fsdp import place_fsdp, place_train_params_fsdp

    def place(spec, mesh, tp, params):
        return (place_fsdp(mesh, tp, min_size=MIN),
                place_train_params_fsdp(spec, mesh, params, tensor_parallel=tensor_parallel,
                                        min_size=MIN))

    return jax_mesh_steps(layout=(2, 2) if tensor_parallel else (4, 1), place=place)


@pytest.fixture(scope="module")
def jax_fsdp_run():
    return _jax_fsdp_run(False)


@pytest.fixture(scope="module")
def jax_hsdp_run():
    return _jax_fsdp_run(True)


def _grads_payload(**over):
    return _steps_payload(waves=_waves(1, 3), **over)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One group of 2 ranks as (2 data x 1 model) FSDP: a 4-step trainer run
    and the same stopped at step 2 (checkpoint A); 4 steps at K = 1 and at
    K = 2; one step's gradients without and with remat; then as (1 x 2):
    A restored, and a run stopped at step 2 (checkpoint C)."""
    tmp = tmp_path_factory.mktemp("fsdp_two_ranks")
    a = str(tmp / "half" / "ckpts" / "last.pt")
    k_steps = _fsdp(_steps_payload(waves=_waves(4, 1)))
    jobs = {"full": ("train", _fsdp(_train_payload(tmp / "full"))),
            "half": ("train", _fsdp(_train_payload(tmp / "half", stop_at_step=2))),
            "k1": ("steps", k_steps),
            "k2": ("steps", dict(k_steps, steps_per_call=2)),
            "grads": ("grads", _fsdp(_grads_payload())),
            "grads_remat": ("grads", _fsdp(_grads_payload(
                distill=dict(_steps_payload()["distill"], remat=True)))),
            "load_a_1x2": ("load_state", dict(_train_payload(tmp / "x"), resume=a,
                                              layout=(1, 2))),
            "tp_half": ("train", _train_payload(tmp / "tp_half", stop_at_step=2,
                                                layout=(1, 2)))}
    return tmp, _spawn(tmp, jobs, 2, (2, 1))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, two_ranks, jax_fsdp_run, jax_hsdp_run):
    """One group of 4 ranks as (4 data x 1 model) FSDP and as (2 x 2) HSDP:
    the dropout steps and the TPU-comparison steps of both; checkpoint A
    restored and resumed at HSDP; an HSDP run stopped at step 2 (checkpoint
    B); and B, C and a one-process checkpoint D restored at FSDP."""
    tmp2, _ = two_ranks
    tmp = tmp_path_factory.mktemp("fsdp_four_ranks")
    run_train(_train_payload(tmp / "one_half", stop_at_step=2))  # D, in this process
    a = str(tmp2 / "half" / "ckpts" / "last.pt")
    ckpts = {"b": tmp / "hsdp_half", "c": tmp2 / "tp_half", "d": tmp / "one_half"}
    hsdp = (2, 2)
    jobs = {"fsdp_dropout": ("steps", _fsdp(_steps_payload())),
            "fsdp_jax": ("steps", _fsdp(jax_fsdp_run[0])),
            "hsdp_dropout": ("steps", _fsdp(_steps_payload(), hsdp)),
            "hsdp_jax": ("steps", _fsdp(jax_hsdp_run[0], hsdp)),
            "load_a_hsdp": ("load_state", _fsdp(dict(_train_payload(tmp / "x"), resume=a),
                                                hsdp)),
            "resume_a_hsdp": ("train", _fsdp(_train_payload(tmp / "resume_a", resume=a),
                                             hsdp)),
            "hsdp_half": ("train", _fsdp(_train_payload(ckpts["b"], stop_at_step=2), hsdp))}
    for k, d in ckpts.items():
        jobs[f"load_{k}_fsdp"] = ("load_state", _fsdp(dict(
            _train_payload(tmp / "x"), resume=str(d / "ckpts" / "last.pt"))))
    return tmp, _spawn(tmp, jobs, 4, (4, 1))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _check_shards(got, n_data):
    """Every split parameter holds 1/n_data of its one-card elements (over
    the model split, if any), its moments too; the big leaves are split."""
    blocks = got["shards"]
    data = {n: b for n, b in blocks.items() if b.data_dim is not None}
    assert len(data) >= 10
    for n, b in data.items():
        whole = int(np.prod(b.shape)) // (b.n_model if b.model_dim is not None else 1)
        assert got["local_numel"][n] == (whole // n_data,) * 3, n
        assert b.n_data == n_data
    assert not any(n.startswith("lambdas.") for n in blocks)
    assert any(n.startswith("projs.") for n in data)


@pytest.mark.parametrize("job,n_data", [("fsdp_dropout", 4), ("hsdp_dropout", 2)])
def test_fsdp_step_with_dropout_matches_one_process(four_ranks, job, n_data):
    """(4 x 1) FSDP and (2 x 2) HSDP, attention and activation dropout 0.1:
    3 steps within 1e-5 (loss) and 2e-5 (every gathered parameter) of one
    process, the generators in step, the grad norm the one-card norm."""
    _, out = four_ranks
    got, want = out[job], run_steps(_steps_payload())
    _close(got, want, f"{job} vs one process")
    assert torch.equal(got["generator"], want["generator"])
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
    _check_shards(got, n_data)
    if job == "hsdp_dropout":  # a q_proj weight: rows over model, columns over data
        b = got["shards"]["student.encoder.transformer.layers.0.attention.q_proj.weight"]
        assert (b.model_dim, b.data_dim) == (0, 1)


@pytest.mark.parametrize("job,run", [("fsdp_jax", "jax_fsdp_run"),
                                     ("hsdp_jax", "jax_hsdp_run")])
def test_fsdp_step_matches_the_tpu_mesh_step(four_ranks, request, job, run):
    """The port's FSDP / HSDP step against the TPU package's placed by
    ``place_fsdp`` / ``place_train_params_fsdp`` (dropout off, its gate
    draws injected): 3 steps within 1e-5 (loss) and 2e-5 (parameters)."""
    _, out = four_ranks
    _close(out[job], request.getfixturevalue(run)[1], f"{job} vs the TPU mesh step")


def test_fsdp_steps_per_call_two_is_bit_for_bit_one(two_ranks):
    _, out = two_ranks
    k1, k2 = out["k1"], out["k2"]
    assert k1["step"] == k2["step"] == 4
    assert k1["metrics"] == k2["metrics"]
    assert torch.equal(k1["generator"], k2["generator"])
    for k, v in k1["params"].items():
        assert torch.equal(k2["params"][k], v), k


def test_fsdp_remat_gradients_equal_fsdp_without_it(two_ranks):
    """With ``remat`` the recompute gathers each weight again: every
    gathered gradient within 1e-4 of its norm of the step without remat.
    That step's loss is within 1e-5 of one process's, and so is every
    gradient past 1e-3 of the global norm (below it, as the key biases',
    whose exact value is 0, a gradient is rounding noise)."""
    _, out = two_ranks
    plain, remat = out["grads"], out["grads_remat"]
    one = run_grads(_grads_payload())
    total = torch.cat([g.flatten() for g in one["grads"].values()]).norm()
    held = 0
    for k, w in plain["grads"].items():
        assert (remat["grads"][k] - w).norm() <= REMAT_GRAD_TOL * w.norm(), k
        if one["grads"][k].norm() >= 1e-3 * total:
            held += 1
            assert (w - one["grads"][k]).norm() <= 1e-5 * one["grads"][k].norm(), k
    assert held >= 20
    np.testing.assert_allclose(plain["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _same_as_file(got: dict, path) -> None:
    """A state restored on a mesh and gathered back equals the file's
    tensors bit for bit (parameters and both moments)."""
    ckpt = torch.load(path, weights_only=True)
    want = {**{f"params/{n}": t for n, t in ckpt["params"].items()},
            **{f"{g}/{n}": t for g in ("mu", "nu") for n, t in ckpt["opt"][g].items()}}
    assert set(want) <= set(got["tensors"])
    for n, t in want.items():
        assert torch.equal(got["tensors"][n], t), n
    assert got["step"] == ckpt["step"] == 2


def test_fsdp_checkpoint_is_one_card_and_restores_at_every_layout(two_ranks, four_ranks,
                                                                  tmp_path):
    """Checkpoint A, written at (2 x 1) FSDP, holds one-card tensors; it
    restores bit for bit at one process, (1 x 2) and (2 x 2) HSDP, and
    resumed at one process and at HSDP to step 4 it ends within 2e-5 of
    the uninterrupted FSDP run."""
    tmp2, out2 = two_ranks
    _, out4 = four_ranks
    path = tmp2 / "half" / "ckpts" / "last.pt"
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["meta"]["layout"] == [2, 1]
    full = out2["full"]
    for k, v in ckpt["params"].items():
        assert v.shape == full["params"][k].shape, k
    _same_as_file(run_load_state(dict(_train_payload(tmp_path / "x"), resume=str(path))), path)
    _same_as_file(out2["load_a_1x2"], path)
    _same_as_file(out4["load_a_hsdp"], path)
    one = run_train(_train_payload(tmp_path / "one", resume=str(path)))
    for name, got in (("(1 x 1)", one), ("(2 x 2) HSDP", out4["resume_a_hsdp"])):
        assert got["step"] == full["step"] == 4
        _close(got, {"params": full["params"]}, f"resumed at {name}")


@pytest.mark.parametrize("ckpt,layout", [("b", [2, 2]), ("c", [1, 2]), ("d", [1, 1])])
def test_checkpoints_of_other_layouts_restore_at_fsdp(two_ranks, four_ranks, ckpt, layout):
    """Checkpoints written at (2 x 2) HSDP (B), (1 x 2) (C) and one process
    (D) restore bit for bit at (4 x 1) FSDP."""
    tmp2, _ = two_ranks
    tmp4, out4 = four_ranks
    path = {"b": tmp4 / "hsdp_half", "c": tmp2 / "tp_half",
            "d": tmp4 / "one_half"}[ckpt] / "ckpts" / "last.pt"
    assert torch.load(path, weights_only=True)["meta"]["layout"] == layout
    _same_as_file(out4[f"load_{ckpt}_fsdp"], path)
    assert len(out4[f"load_{ckpt}_fsdp"]["local_numel"]) >= 10
