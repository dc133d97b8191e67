"""The plain reference held against the port's CPU path at a tiny size:
the serving forward, and three stage-1 steps with dropout, gates and the
optimizer (the reference draws every random number itself, in the step's
order, from a generator with the same seed).  The reference imports nothing
of the port; this test imports both."""

import pytest
import torch

from benchmark.reference import distill as RD
from benchmark.reference import model as M
from benchmark.tests import tiny


def port_model(config, params):
    from benchmark.lib.program import load_model

    return load_model(config, params, "cpu")


@pytest.mark.parametrize("wavlm", [False, True], ids=["hubert", "wavlm"])
@pytest.mark.parametrize("which", ["teacher", "served"])
def test_forward_matches_the_port(wavlm, which):
    cfg = tiny.model_config(wavlm) if which == "teacher" else tiny.served_config(wavlm)
    g = torch.Generator().manual_seed(11)
    P = M.make_params(cfg, g)
    wave = 0.1 * torch.randn(3, 16000, generator=g)
    lens = torch.tensor([16000, 12000, 9000])
    with torch.no_grad():
        got, got_len = port_model(cfg, P).extract_features(wave, lens)
        want, want_len = M.extract_features(P, cfg, wave, lens)
    assert got_len.tolist() == want_len.tolist()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("wavlm", [False, True], ids=["hubert", "wavlm"])
def test_three_distill_steps_match_the_port(wavlm):
    from dphubert_torch.train import init_train_state, make_train_step

    from benchmark.lib.program import distill_config

    tcfg, scfg = tiny.model_config(wavlm), tiny.model_config(wavlm, prune=True)
    tp = M.make_params(tcfg, torch.Generator().manual_seed(1))
    sp = M.make_params(scfg, torch.Generator().manual_seed(2))
    cfg = distill_config(tiny.RECIPE, "float32")
    state, tx = init_train_state(student=port_model(scfg, sp), cfg=cfg, teacher_embed_dim=128,
                                 device="cpu")
    state.generator.manual_seed(77)
    step = make_train_step(port_model(tcfg, tp), cfg, tx, steps_per_call=3)
    pcm = (3000 * torch.randn(3, 2, 8000, generator=torch.Generator().manual_seed(3))).to(
        torch.int16)
    state, metrics = step(state, (pcm.numpy(), None))

    ref = RD.Trainer(tcfg, tp, scfg, sp, RD.Recipe.of(tiny.RECIPE))
    draws = M.Draws(torch.Generator().manual_seed(77))
    losses = [float(ref.step(RD.pcm_to_float(pcm[j]), draws)[0]) for j in range(3)]
    assert metrics["loss"].tolist() == pytest.approx(losses, rel=1e-6)
    named = state.named_params()
    assert set(named) == set(ref.params)
    for n, p in named.items():
        assert (p.detach() - ref.params[n].detach()).abs().max().item() <= 1e-6, n
