"""What decides ``correct``: the served tokens and audio of a sample of
finished requests against the plain reference (reference/model.py),
and the same numbers for each control: the reference with one part (the
talker, the code predictor or the vocoder) one precision step below the
configured one, put in the program's place.

Numbers read (those that the configuration's ``limits`` name are
compared, each against its limit):

- ``token_gap``: the widest gap, over every step of every sampled
  request and each of its 16 codes, by which the served code scores
  below the reference's best: code 0 (or the EOS that ended the
  request) under the greedy policy's transforms of the talker's logits,
  groups 1..15 under the code predictor's logits. A served token that
  the reference would force otherwise, or that is outside the
  vocabulary, reads infinite.
- ``group_gap_msq``: the mean of the squared gaps of groups 1..15 over
  every step of every sampled request. Each step feeds the talker's
  hidden state to 15 group choices, so this holds the talker to its
  precision where the widest gap does not (the bf16 talker against its
  int8 control, PERF.md). A gap grows with the logit error and so does
  the chance of one, so the mean square parts a control from the
  program further than the mean does.
- ``audio_lsb``: the largest difference, in int16 steps, between the
  audio a client received and the reference vocoder's decode of the
  served tokens (a request's audio of the wrong length reads infinite).

Read for the record: ``code0_gap`` (code 0's widest gap),
``code0_gap_mean``, ``code0_miss_pct`` (the share of steps whose code 0
is not the reference's best), ``group_gap_mean`` and ``token_gap_mean``
(the mean gap over all 16 codes).

A control reads, at the same prompts and tokens, the reference's gap of
each token that its lower precision puts first, and the difference of
its vocoder's audio (TF32) from the reference's."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import model as M

# one precision step below each stated one
LOWER = {"bfloat16": "int8", "int8": "int4", "float32": "tf32"}
# the controls: each lowers one part and leaves the others as configured
CONTROLS = ("talker", "code_predictor", "vocoder")


def _gaps(scores: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    ok = (chosen >= 0) & (chosen < scores.shape[-1])
    safe = torch.where(ok, chosen, torch.zeros_like(chosen)).long()
    got = torch.gather(scores, -1, safe[..., None])[..., 0]
    gap = scores.max(-1).values - got
    return torch.where(ok, gap, torch.full_like(gap, math.inf))


def _steps(codes: torch.Tensor, budget: int) -> torch.Tensor:
    """The code 0 drawn at each step: the served codes, then EOS when the
    request ended before its budget."""
    c0 = codes[:, 0].long()
    if M.step_count(len(codes), budget) > len(codes):
        c0 = torch.cat([c0, torch.tensor([M.CODEC_EOS], device=c0.device)])
    return c0


def _audio_diff(audio: torch.Tensor, ref: torch.Tensor) -> float:
    if audio.shape != ref.shape:
        return math.inf
    return float((audio.int() - ref.int()).abs().max()) if len(audio) \
        else 0.0


class _Sums:
    """One reader's numbers (the program's or a control's), gathered over
    the sampled requests."""

    def __init__(self):
        self.token_gap = self.code0_gap = self.audio_lsb = 0.0
        self.g0_sum = self.gc_sum = self.gc_sq = 0.0
        self.g0_n = self.gc_n = self.miss = 0

    def add(self, g0: torch.Tensor, gc: torch.Tensor, d_audio: float):
        if len(g0):
            self.code0_gap = max(self.code0_gap, float(g0.max()))
            self.g0_sum += float(g0.sum())
            self.g0_n += len(g0)
            self.miss += int((g0 > 0).sum())
        if gc.numel():
            self.token_gap = max(self.token_gap, float(gc.max()))
            self.gc_sum += float(gc.sum())
            self.gc_sq += float((gc * gc).sum())
            self.gc_n += gc.numel()
        self.token_gap = max(self.token_gap, self.code0_gap)
        self.audio_lsb = max(self.audio_lsb, d_audio)

    def numbers(self) -> Dict[str, float]:
        return {"token_gap": self.token_gap, "code0_gap": self.code0_gap,
                "code0_gap_mean": self.g0_sum / max(self.g0_n, 1),
                "group_gap_mean": self.gc_sum / max(self.gc_n, 1),
                "group_gap_msq": self.gc_sq / max(self.gc_n, 1),
                "token_gap_mean": (self.g0_sum + self.gc_sum)
                / max(self.g0_n + self.gc_n, 1),
                "code0_miss_pct": 100.0 * self.miss / max(self.g0_n, 1),
                "audio_lsb": self.audio_lsb}


def readings(cfg: dict, weights: dict, requests: List[dict], device,
             controls: Sequence[str] = ()) -> Dict[str, Dict[str, float]]:
    """The numbers over ``requests`` (dicts with ``ids`` (n_text,)
    int, ``codes`` (n, 16) int, ``audio`` int16 (n * 1920,) as received):
    under ``"program"`` for the program's tokens and audio, and under
    each name in ``controls`` for that control in the program's place.
    Runs request by request, in float32, TF32 off."""
    prec = cfg["precision"]
    s = cfg["sampling"]
    budget = int(cfg["max_tokens"])
    sums = {k: _Sums() for k in ("program",) + tuple(controls)}
    with torch.no_grad(), M.precision(False):
        ref = M.prepare(weights, prec["talker"], prec["code_predictor"],
                        device)
        low_t = (M.prepare(weights, LOWER[prec["talker"]],
                           prec["code_predictor"], device)[0]
                 if "talker" in controls else None)
        low_c = (M.prepare(weights, prec["talker"],
                           LOWER[prec["code_predictor"]], device)[1]
                 if "code_predictor" in controls else None)
        for r in requests:
            ids = torch.as_tensor(np.asarray(r["ids"]), device=device)
            codes = torch.as_tensor(np.asarray(r["codes"]),
                                    device=device).long()
            n_text, n = len(r["ids"]), len(codes)
            c0 = _steps(codes, budget)
            T = len(c0)
            logits, hid = M.talker_forward(ref[0], ref[1], cfg["talker"],
                                           ids, codes)
            scores, force = M.code0_scores(logits[:T], c0, n_text, s)
            glog = M.cp_logits(ref[1], ref[0], cfg["code_predictor"],
                               hid[:n], codes)
            ref_audio = M.vocode_int16(ref[2], cfg["vocoder"], codes)
            eos = torch.full_like(c0, M.CODEC_EOS)
            best0 = _gaps(scores, torch.where(force, eos,
                                              M.greedy_choice(scores)))
            best = _gaps(glog, M.greedy_choice(glog))
            # the program: a forced step must serve EOS, and then scores 0
            g0 = _gaps(scores, c0)
            g0 = torch.where(force, torch.where(
                c0 == M.CODEC_EOS, torch.zeros_like(g0),
                torch.full_like(g0, math.inf)), g0)
            audio = torch.as_tensor(np.asarray(r["audio"]), device=device)
            sums["program"].add(g0, _gaps(glog, codes[:, 1:]),
                                _audio_diff(audio, ref_audio))
            if low_t is not None:
                lg, lh = M.talker_forward(low_t, ref[1], cfg["talker"],
                                          ids, codes)
                ls, lforce = M.code0_scores(lg[:T], c0, n_text, s)
                lgl = M.cp_logits(ref[1], low_t, cfg["code_predictor"],
                                  lh[:n], codes)
                sums["talker"].add(
                    _gaps(scores, torch.where(lforce, eos,
                                              M.greedy_choice(ls))),
                    _gaps(glog, M.greedy_choice(lgl)), 0.0)
            if low_c is not None:
                lgl = M.cp_logits(low_c, ref[0], cfg["code_predictor"],
                                  hid[:n], codes)
                sums["code_predictor"].add(
                    best0, _gaps(glog, M.greedy_choice(lgl)), 0.0)
            if "vocoder" in controls:
                sums["vocoder"].add(best0, best, _audio_diff(
                    M.vocode_int16(ref[2], cfg["vocoder"], codes, tf32=True),
                    ref_audio))
    return {k: v.numbers() for k, v in sums.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a missing number fails)."""
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)
