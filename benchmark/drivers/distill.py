"""The stage-1 distill cells: the recipe's step as the trainer runs it, and
the mix's generator (``kind`` "distill").

The feed: the static-shape batcher's ladder (``ladder``, a copy of the
recipe's rule: geometric rungs from ``min_len`` to ``max_len`` rounded down
to 320-sample frames, batch ``seconds_per_batch * 16000 // rung`` clips) cut
to ``kept_rungs``; one cycle of ``cycle_groups`` same-rung groups of
``steps_per_dispatch`` batches, each kept rung standing for the rungs nearest
it and weighted by their share of the length table's audio (at least one
group each); the cycle's order drawn from the seed, starting on the check
rung; int16 PCM made on the card.

Set-up builds the teacher and the gated student from weights the benchmark
makes from the seed, the train state, and one ``make_train_step(...,
steps_per_call=K)`` object (``GraphedSteps``: a CUDA graph of K steps per
batch shape).  It drives that object through the trainer's own feed
(``trainer._device_prefetch``: pinned host memory, a non-blocking copy,
one group ahead): each kept rung's first group, which the object runs
eagerly and then captures.  Then, for each kept rung, it puts the state
back as it was before the first step (parameters, moments, counters and
the generator's offset) and replays that rung's first group: the check
reads what these replays produce.  The window replays the cycle of groups
until ``--seconds`` have passed, ending at a cycle's end, reading each
group's losses after the next group is queued (the trainer's logging, one
group behind), so the card always has the next group.

The check: the reference follows the check rung's first group (K steps)
from the same weights, batches and generator seed, and takes the first
step's loss on each other kept rung's first batch.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..lib import flops as FL
from ..lib import program
from ..lib.checks import leaf_gap, leaf_gaps, rel_gap
from ..lib.trace import WINDOW
from ..lib.traffic import FRAME, SR, table
from ..reference import distill as RD
from ..reference import model as M

# -- the feed ----------------------------------------------------------------


def ladder(mix: dict) -> List[Tuple[int, int]]:
    """(batch size, samples) of every rung of the static-shape batcher."""
    lo, hi, n = mix["min_len"], mix["max_len"], mix["num_shapes"]
    ratio = (hi / lo) ** (1.0 / (n - 1))
    rungs = [lo]
    while rungs[-1] < hi and len(rungs) < n:
        rungs.append(min(int(round(rungs[-1] * ratio)), hi))
    rungs = sorted({(r // FRAME) * FRAME for r in rungs})
    tokens = int(mix["seconds_per_batch"] * SR)
    return [(tokens // r, r) for r in rungs]


def rung_weights(mix: dict) -> np.ndarray:
    """Each kept rung's share of the audio the batcher keeps: a clip of
    length l (min_len <= l <= max_len) lands on the largest rung <= l; a
    kept rung takes the rungs nearest it in the ladder."""
    rungs = [r for _, r in ladder(mix)]
    kept = mix["kept_rungs"]
    lo, hi, w = table(mix)
    edges = [r / SR for r in rungs] + [mix["max_len"] / SR]
    share = np.zeros(len(rungs))
    for i in range(len(rungs)):
        a, b = edges[i], edges[i + 1]
        for blo, bhi, bw in zip(lo, hi, w):
            x, y = max(a, blo), min(b, bhi)
            if y > x:  # utterances in [x, y), their audio cropped to the rung
                share[i] += bw * (y - x) / (bhi - blo) * rungs[i] / SR
    out = np.zeros(len(kept))
    for i in range(len(rungs)):
        out[int(np.argmin([abs(i - k) for k in kept]))] += share[i]
    return out / out.sum()


def cycle_counts(mix: dict) -> List[int]:
    """Groups of each kept rung in one cycle: largest remainders of the
    weights, at least one each."""
    n = mix["cycle_groups"]
    w = rung_weights(mix) * n
    counts = np.maximum(np.floor(w).astype(int), 1)
    while counts.sum() < n:
        counts[int(np.argmax(w - counts))] += 1
    while counts.sum() > n:
        over = np.where(counts > 1, counts - w, -np.inf)
        counts[int(np.argmax(over))] -= 1
    return counts.tolist()


@dataclass
class Feed:
    shapes: List[Tuple[int, int]]   # (B, T) of each kept rung
    cycle: List[int]                # kept-rung index of each group of the cycle
    groups: List[np.ndarray]        # (K, B, T) int16 PCM of each group of the cycle

    def firsts(self) -> Dict[int, int]:
        """The slot of each kept rung's first group, the check rung's
        (slot 0) first."""
        out: Dict[int, int] = {}
        for slot, rung in enumerate(self.cycle):
            out.setdefault(rung, slot)
        return out


def feed(mix: dict, seed: int, device) -> Feed:
    lad = ladder(mix)
    shapes = [lad[i] for i in mix["kept_rungs"]]
    counts = cycle_counts(mix)
    rng = np.random.default_rng(seed)
    cycle = [i for i, c in enumerate(counts) for _ in range(c)]
    rng.shuffle(cycle)
    # the reference follows the check rung's first group: the cycle starts
    # there, at the same place for every seed
    j = cycle.index(mix["kept_rungs"].index(mix["check_rung"]))
    cycle = cycle[j:] + cycle[:j]
    g = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    K, level = mix["steps_per_dispatch"], mix["level"] * 32768.0
    groups = []
    for i in cycle:
        B, T = shapes[i]
        x = torch.randn((K, B, T), generator=g, device=device).mul_(level)
        groups.append(x.clamp_(-32768, 32767).to(torch.int16).cpu().numpy())
    return Feed(shapes, cycle, groups)


# -- the driver --------------------------------------------------------------


class Driver:
    kind = "train"

    def __init__(self, config: dict, mix: dict, seeds: Dict[str, int], device):
        self.config, self.mix, self.seeds, self.device = config, mix, seeds, device
        self.dtype = config["precision"]
        self.K = mix["steps_per_dispatch"]

    # -- set-up ------------------------------------------------------------

    def _weights(self):
        dev = self.device
        t = M.make_params(self.config["teacher"],
                          torch.Generator(device=dev).manual_seed(self.seeds["teacher"]))
        s = M.make_params(self.config["student"],
                          torch.Generator(device=dev).manual_seed(self.seeds["student"]))
        return t, s

    def make_feed(self) -> None:
        self.feed = feed(self.mix, self.seeds["data"], self.device)

    def setup(self) -> None:
        from dphubert_torch.train import init_train_state, make_train_step
        from dphubert_torch.train.trainer import _device_prefetch

        self.prefetch = _device_prefetch
        tw, sw = self._weights()
        teacher = program.load_model(self.config["teacher"], tw, self.device)
        student = program.load_model(self.config["student"], sw, self.device)
        del tw, sw
        cfg = program.distill_config(self.config["recipe"], self.dtype)
        state, tx = init_train_state(student=student, cfg=cfg,
                                     teacher_embed_dim=M.arch(self.config["teacher"]).embed,
                                     device=self.device)
        del student
        state.generator.manual_seed(self.seeds["step"])
        self.teacher, self.state, self.tx = teacher, state, tx
        self.step = make_train_step(teacher, cfg, tx, steps_per_call=self.K)
        self.make_feed()

        start = self._save()
        firsts = self.feed.firsts()
        eager = self._run(list(firsts.values()))  # eager, then captured
        # each graph replayed from the state before the first step
        self.observed = {"rung_losses": {}, "eager_losses": eager[0]}
        for rung, slot in firsts.items():
            self._restore(start)
            losses = self._run([slot])[0]
            if slot == 0:
                opt = self.state.opt_state
                self.observed["losses"] = losses
                self.observed["moments"] = {n: t.double().norm().item()
                                            for n, t in opt.mu.items()}
                self.observed["params"] = {n: p.detach().float().to("cpu", copy=True)
                                           for n, p in self.state.named_params().items()}
            else:
                self.observed["rung_losses"][rung] = losses[0]
        del start
        self._sync()

    def _tensors(self) -> Dict[str, torch.Tensor]:
        opt = self.state.opt_state
        out = {f"params/{n}": p for n, p in self.state.named_params().items()}
        for group in ("mu", "nu", "acc"):
            out.update({f"{group}/{n}": t for n, t in (getattr(opt, group) or {}).items()})
        return out

    def _save(self):
        """The train state on the host: no second copy of it on the card."""
        opt = self.state.opt_state
        return ({n: t.detach().to("cpu", copy=True) for n, t in self._tensors().items()},
                (self.state.step, opt.count, opt.mini_step), self.state.generator.get_state())

    @torch.no_grad()
    def _restore(self, saved) -> None:
        """Put the state back in place, in the tensors the graphs read."""
        tensors, counters, generator = saved
        for n, t in self._tensors().items():
            t.copy_(tensors[n])
        opt = self.state.opt_state
        self.state.step, opt.count, opt.mini_step = counters
        self.state.generator.set_state(generator)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _groups(self, slots):
        for slot in slots:
            yield self.feed.groups[slot], None

    def _run(self, slots) -> List[list]:
        """Run the groups of ``slots`` through the step, fed as the trainer
        feeds it; their losses."""
        out = []
        for wave, lengths, _ in self.prefetch(self._groups(slots), self.device):
            self.state, metrics = self.step(self.state, (wave, lengths))
            out.append(metrics["loss"].tolist())
        return out

    # -- window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        cycle = len(self.feed.cycle)
        done: List[int] = []
        losses: List[torch.Tensor] = []
        pending = None

        def slots():
            i = 0
            while True:
                yield self.feed.groups[i % cycle], None
                i += 1

        with record_function(WINDOW):
            t0 = time.perf_counter()
            fed = self.prefetch(slots(), self.device)
            i = 0
            while True:
                with record_function("bench.feed"):
                    wave, lengths, _ = next(fed)
                with record_function("bench.dispatch"):
                    self.state, metrics = self.step(self.state, (wave, lengths))
                done.append(self.feed.cycle[i % cycle])
                i += 1
                if pending is not None:
                    with record_function("bench.read_losses"):
                        losses.append(pending.cpu())
                pending = metrics["loss"]
                if i % cycle == 0 and time.perf_counter() - t0 >= seconds:
                    break
            losses.append(pending.cpu())
            self._sync()
            window_s = time.perf_counter() - t0
        self.done = done
        loss = torch.cat(losses)
        audio = sum(self.K * B * T for B, T in (self.feed.shapes[r] for r in done)) / SR
        flops = sum(self.K * FL.train_step_flops(self.config["teacher"], self.config["student"],
                                                 *self.feed.shapes[r]) for r in done)
        peak = (torch.cuda.max_memory_reserved(self.device) if self.device.type == "cuda" else 0)
        return {"window_s": window_s, "audio_s": audio, "attempted": len(done) * self.K,
                "failed": int((~torch.isfinite(loss)).sum()), "flops": flops,
                "e2e": {"train_audio_s_per_s": audio / window_s, "train_peak_gib": peak / 2**30}}

    def attention_ops(self) -> List[FL.AttentionOp]:
        """The attention ops of the window's steps: the teacher's forwards,
        the student's forwards and backwards."""
        ops = []
        t, s = self.config["teacher"], self.config["student"]
        for r in self.done:
            B, T = self.feed.shapes[r]
            L = FL.frames(t, T)
            step = (FL.attention_ops(t, [L] * B, False) + FL.attention_ops(s, [L] * B, False)
                    + FL.attention_ops(s, [L] * B, True))
            ops += step * self.K
        return ops

    # -- check -------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.step, self.state, self.tx, self.teacher
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The reference over the replayed groups; the numbers compared."""
        return compare(self.observed, self.reference())

    def reference(self, prec=M.FP32, fault=None) -> dict:
        """What the reference makes of the replayed groups from the same
        start: the first step's loss on each other kept rung's first
        batch, then the K steps of the check rung's first group.  ``prec``
        and ``fault`` make the readings of the limits' calibration: a lower
        precision, or a fault planted in the reference put in the program's
        place ("half": the mean over half the batch; "unchanged": no
        update)."""
        tw, sw = self._weights()
        trainer = RD.Trainer(self.config["teacher"], tw, self.config["student"], sw,
                             RD.Recipe.of(self.config["recipe"]), prec)
        start = {n: p.detach().float().to("cpu", copy=True) for n, p in trainer.params.items()}
        draws = lambda: M.Draws(torch.Generator(device=self.device).manual_seed(
            self.seeds["step"]))

        def batch(slot, j):
            wave = RD.pcm_to_float(torch.from_numpy(self.feed.groups[slot][j]).to(self.device))
            return wave[: wave.shape[0] // 2] if fault == "half" else wave

        out = {"losses": [], "start": start, "rung_losses": {}}
        for rung, slot in self.feed.firsts().items():
            if slot:
                loss, _ = trainer.loss_and_grads(batch(slot, 0), draws(), grads=False)
                out["rung_losses"][rung] = float(loss)
        d = draws()
        for j in range(self.K):
            loss, grads = trainer.loss_and_grads(batch(0, j), d)
            if fault != "unchanged":
                trainer.update(grads)
            out["losses"].append(float(loss))
            if j == 0:
                out["grad_raw"] = {n: g.double().norm().item() for n, g in grads.items()}
        out["moments"] = {n: t.double().norm().item() for n, t in trainer.mu.items()}
        out["params"] = {n: p.detach().float().to("cpu", copy=True) for n, p in trainer.params.items()}
        del trainer, tw, sw
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the worst relative loss gap, over the check
    group's steps and the other rungs' first steps; by the worst leaf, the
    gap of the first moment's norm after the check group (its K clipped
    gradients, weighted as the optimizer weights them); and the median
    leaf's gap of the parameters' change over the group (``checks.leaf_gaps``).
    The change is compared at the median leaf, not the worst: a gate's
    log_alpha element whose gradient is near Adam's epsilon moves by a
    share of the step that round-off decides, so the worst leaf swings
    from seed to seed.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change."""
    pairs = list(zip(got["losses"], ref["losses"]))
    pairs += [(got["rung_losses"].get(r, float("nan")), v) for r, v in ref["rung_losses"].items()]
    loss = max(rel_gap(a, b) for a, b in pairs)
    moment = leaf_gap(got["moments"], ref["moments"])
    med = float(np.median(list(ref["grad_raw"].values())))
    moving = [n for n, v in ref["grad_raw"].items() if v >= 1e-3 * med]
    change_got = {n: (got["params"][n] - ref["start"][n]).double().norm().item() for n in moving}
    change_ref = {n: (ref["params"][n] - ref["start"][n]).double().norm().item() for n in moving}
    change = leaf_gaps(change_got, change_ref)
    worst = max(change, key=change.get)
    return {"loss_gap": loss, "moment_gap": moment[0],
            "change_gap": float(np.median(list(change.values()))),
            "worst": {"moment": moment[1], "change": worst, "change_gap": change[worst]},
            "losses": {"program": got["losses"], "reference": ref["losses"],
                       "program_eager": got.get("eager_losses"),
                       "rungs_program": got["rung_losses"], "rungs_reference": ref["rung_losses"]},
            "leaves_left_out": len(ref["grad_raw"]) - len(moving)}
