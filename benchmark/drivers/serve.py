"""The feature-extraction serving cells: ``Predictor.extract`` in a closed
loop with one client, and the mix's generator (``kind`` "serve").

The feed: requests of ``clips_per_request`` clips.  Clip lengths are the
length table's quantiles between ``clip_seconds`` (the table cut to that
range), one per clip of the pool, dealt to requests by a fixed draw
(``deal_seed``), so every seed sends the same requests; the seed sets the
requests' order and each clip's samples, a slice at an offset drawn from
the seed of one noise buffer made on the card.

Set-up loads the served (pruned) model from weights the benchmark makes from
the seed and wraps it in the program's ``Predictor`` (the mix's dtype,
``length_step``, ``max_batch``); it sends every request of the pool once,
largest first, which warms every padded batch shape.  The window sends the
pool's requests in turn, each when the previous one has returned, until
``--seconds`` have passed, ending at the pool's end; a request's latency is
the wall time of its ``extract`` call.  The answers of the check's requests
(the longest request and others drawn from the seed) are kept and, after the
window, held against the reference on the same clips, batched and padded as
the served path batches them (the first conv's GroupNorm takes its
statistics over the padded length).
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..lib import flops as FL
from ..lib import program
from ..lib.checks import feature_gap
from ..lib.trace import WINDOW
from ..lib.traffic import SR, quantiles
from ..reference import model as M

@dataclass
class Feed:
    requests: List[List[np.ndarray]]  # float32 clips of each request of the pool
    check: List[int]                  # the requests whose answers are checked


def feed(mix: dict, seed: int, device) -> Feed:
    n_req, per = mix["pool_requests"], mix["clips_per_request"]
    lo_s, hi_s = mix["clip_seconds"]
    lengths = np.round(quantiles(mix, n_req * per, lo_s, hi_s) * SR).astype(np.int64)
    # the same requests for every seed (the clips dealt by a fixed draw, so
    # the padding work is the same); the seed sets their order and samples
    deal = np.random.default_rng(mix["deal_seed"]).permutation(len(lengths))
    rng = np.random.default_rng(seed)
    lengths = lengths[deal].reshape(n_req, per)[rng.permutation(n_req)]
    span = int(math.ceil(hi_s * SR)) * 2
    g = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    noise = torch.randn(span, generator=g, device=device).mul_(mix["level"]).cpu().numpy()
    reqs = []
    for row in lengths:
        offs = rng.integers(0, span - row.max(), size=per)
        reqs.append([noise[o:o + n] for o, n in zip(offs, row)])
    longest = int(np.argmax(lengths.max(axis=1)))
    others = [i for i in rng.permutation(n_req).tolist() if i != longest]
    return Feed(reqs, [longest] + others[:mix["check_requests"] - 1])


def batches(clips: Sequence[np.ndarray], length_step: int, max_batch: int
            ) -> List[Tuple[List[int], int]]:
    """How the served path batches a request: clips sorted by length, cut
    into batches of at most ``max_batch``, each padded to a multiple of
    ``length_step`` samples -> (clip indices, padded samples) per batch."""
    order = sorted(range(len(clips)), key=lambda i: len(clips[i]))
    out = []
    for s in range(0, len(order), max_batch):
        idx = order[s:s + max_batch]
        longest = max(len(clips[i]) for i in idx)
        out.append((idx, max(length_step, -(-longest // length_step) * length_step)))
    return out


class Driver:
    kind = "serve"

    def __init__(self, config: dict, mix: dict, seeds: Dict[str, int], device):
        self.config, self.mix, self.seeds, self.device = config, mix, seeds, device
        self.dtype = mix["dtype"]
        self.served = config["served"]

    def _weights(self):
        return M.make_params(self.served,
                             torch.Generator(device=self.device).manual_seed(self.seeds["served"]))

    def make_feed(self) -> None:
        self.feed = feed(self.mix, self.seeds["data"], self.device)

    def setup(self) -> None:
        from dphubert_torch.serve import Predictor

        model = program.load_model(self.served, self._weights(), self.device)
        self.predictor = Predictor(model, length_step=self.mix["length_step"],
                                   max_batch=self.mix["max_batch"],
                                   dtype=getattr(torch, self.dtype), device=self.device)
        self.make_feed()
        # every request of the pool once, the largest first: each padded
        # shape is warmed, and the host's allocator has held the largest
        # arrays before the window, in the same order for every seed
        size = lambda clips: sum(len(idx) * T for idx, T in batches(
            clips, self.mix["length_step"], self.mix["max_batch"]))
        for clips in sorted(self.feed.requests, key=size, reverse=True):
            self.predictor.extract(clips)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        reqs = self.feed.requests
        keep = set(self.feed.check)
        self.answers: Dict[int, List[np.ndarray]] = {}
        lat, done, ok, failed = [], [], [], 0
        with record_function(WINDOW):
            t0 = time.perf_counter()
            i = 0
            while True:
                r = i % len(reqs)
                s = time.perf_counter()
                try:
                    with record_function("bench.extract"):
                        out = self.predictor.extract(reqs[r])
                except RuntimeError:
                    failed += 1
                    out = None
                lat.append(time.perf_counter() - s)
                done.append(r)
                if out is not None:
                    ok.append(r)
                if out is not None and r in keep and r not in self.answers:
                    self.answers[r] = out
                i += 1
                if i % len(reqs) == 0 and time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        self.done = done
        audio = sum(len(c) for r in ok for c in reqs[r]) / SR
        ms = sorted(1e3 * x for x in lat)
        # a failed request misses every latency limit
        ms = ms[:len(ms) - failed] + [float("inf")] * failed
        p95 = float(np.percentile(np.array(ms), 95, method="higher")) if ms else float("inf")
        flops = sum(sum(FL.forward_flops(self.served, [len(c) for c in reqs[r]]).values())
                    for r in ok)
        peak = (torch.cuda.max_memory_reserved(self.device) if self.device.type == "cuda" else 0)
        return {"window_s": window_s, "audio_s": audio, "attempted": len(done), "failed": failed,
                "flops": flops,
                "e2e": {"serve_audio_s_per_s": audio / window_s, "serve_p95_ms": p95},
                "peak_bytes": peak}

    def attention_ops(self) -> List[FL.AttentionOp]:
        ops = []
        for r in self.done:
            clips = self.feed.requests[r]
            for idx, _ in batches(clips, self.mix["length_step"], self.mix["max_batch"]):
                lens = [FL.frames(self.served, len(clips[i])) for i in idx]
                ops += FL.attention_ops(self.served, lens, False, self.dtype)
        return ops

    def release(self) -> None:
        del self.predictor
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ref = self.reference()
        gaps = {}
        for r, clips in ref.items():
            got = self.answers.get(r)
            if got is None:
                gaps[r] = float("inf")  # an answer that never came
                continue
            gaps[r] = max(feature_gap(g, w) for g, w in zip(got, clips))
        worst = max(gaps, key=gaps.get)
        return {"feature_gap": gaps[worst], "worst_request": worst,
                "requests_checked": len(gaps)}

    def reference(self, prec=M.FP32) -> Dict[int, List[np.ndarray]]:
        """The reference's final-layer features of the check's requests, each
        clip's valid frames, batched as the served path batches them."""
        P = self._weights()
        out = {}
        with torch.no_grad():
            for r in self.feed.check:
                clips = self.feed.requests[r]
                feats: List[np.ndarray] = [None] * len(clips)
                for idx, T in batches(clips, self.mix["length_step"],
                                              self.mix["max_batch"]):
                    wave = torch.zeros(len(idx), T, device=self.device)
                    for j, i in enumerate(idx):
                        wave[j, :len(clips[i])] = torch.from_numpy(clips[i]).to(self.device)
                    lens = torch.tensor([len(clips[i]) for i in idx], device=self.device)
                    hs, fl = M.extract_features(P, self.served, wave, lens, prec=prec)
                    last = hs[-1].float().cpu().numpy()
                    for j, i in enumerate(idx):
                        feats[i] = last[j, :int(fl[j])]
                out[r] = feats
        return out
