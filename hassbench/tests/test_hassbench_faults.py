"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU, a small image size), the rest
of a run is driven as it is on the card. One fault per case that a search
cell can have; the cells run on one chip, so there is no exchange between
chips to leave out."""
import time

import pytest
import torch

from hassbench import harness

CELLS = ("resnet18.search.b8", "mobilenetv3l.search.b8")


def _run(cell_name, seed=21):
    cell = harness.find_cell(cell_name)
    return harness.run(cell, seed, 1.5, False, time.perf_counter(),
                       device="cpu", img_res=32)


def _state_unchanged(monkeypatch):
    """The device pass hands back the previous round's rows."""
    from repro_torch.core.hass import CNNEvaluator
    real, last = CNNEvaluator._pass, {}

    def stale(self, s_w, s_a, codes, n_real):
        out = real(self, s_w, s_a, codes, n_real)
        prev = last.get(id(self))
        last[id(self)] = out
        return prev if prev is not None and len(prev[0]) == len(out[0]) \
            else out
    monkeypatch.setattr(CNNEvaluator, "_pass", stale)


def _half_the_batch(monkeypatch):
    """The clip's zero count taken over half of the images, doubled (the
    mean over the rest)."""
    from repro_torch.kernels import ref
    real = ref.act_clip_count_batched_ref

    def half(x, taus):
        y, cnt = real(x, taus)
        n = x.shape[0] // 2
        _, cnt_half = real(x[:n].contiguous(), taus)
        return y, (2 * cnt_half).to(cnt.dtype)
    monkeypatch.setattr(ref, "act_clip_count_batched_ref", half)


def _accuracy_altered(monkeypatch):
    """One image more or less keeps its class in each pass's first row."""
    from repro_torch.core.hass import CNNEvaluator
    real = CNNEvaluator._device_pass

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        step = 1.0 / self.images.shape[0]
        out[0, 0] = torch.where(out[0, 0] < 1.0, out[0, 0] + step,
                                out[0, 0] - step)
        return out
    monkeypatch.setattr(CNNEvaluator, "_device_pass", altered)


def _one_slot_one_layer_altered(monkeypatch):
    """The measured clipped share of one layer altered by a quarter in each
    pass's first row only: one pair in 8 x L, a thin share of all pairs."""
    from repro_torch.core.hass import CNNEvaluator
    real = CNNEvaluator._device_pass

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        L = (out.shape[1] - 1) // 3
        j = 1 + L + L // 2
        out[0, j] = torch.where(out[0, j] < 0.5, out[0, j] + 0.25,
                                out[0, j] - 0.25)
        return out
    monkeypatch.setattr(CNNEvaluator, "_device_pass", altered)


def _pruner_altered(monkeypatch):
    """Each weight threshold one float32 step too high: at most a weight
    more pruned per layer."""
    from repro_torch.core import pruning
    real = pruning.threshold_for_sparsity_sorted

    def up(asort, s):
        tau = real(asort, s)
        return torch.where(tau > 0, torch.nextafter(
            tau, torch.full_like(tau, float("inf"))), tau)
    monkeypatch.setattr(pruning, "threshold_for_sparsity_sorted", up)


def _throughput_altered(monkeypatch):
    """The modeled throughput one part in a million off where the Eq. 6
    terms are read off the frontier."""
    from repro_torch.core import hass
    real = hass.frontier_hw_metrics

    def off(ev, f):
        m = real(ev, f)
        m["thr"] *= 1.000001
        return m
    monkeypatch.setattr(hass, "frontier_hw_metrics", off)


FAULTS = {"state_unchanged": (_state_unchanged, "s_w_mismatch"),
          "half_the_batch": (_half_the_batch, "s_a_apart"),
          "answer_altered_accuracy": (_accuracy_altered, "acc_mismatch"),
          "answer_altered_clip_one_slot": (_one_slot_one_layer_altered,
                                           "s_a_layer_apart"),
          "answer_altered_pruner": (_pruner_altered, "s_w_mismatch"),
          "answer_altered_throughput": (_throughput_altered, "hw_gap")}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 8 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    c = out["checks"][number]
    assert not c["value"] <= c["limit"], out["checks"]
