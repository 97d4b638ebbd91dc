"""The comparison that decides ``correct``, on the CPU at tiny sizes: the
port passes it at the configuration's precision, the reference in a lower
precision put in the port's place fails it, and a run with the timed path
broken underneath (a step that leaves the state unchanged, half of the
batch left out, a served token altered) comes out not correct."""
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import controls, harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY_DECK = {"dist": "lognormal", "median": 24, "sigma": 0.7, "min": 8,
             "max": 40, "deck": 6, "rounds": 2}
#: limits for the tiny cells, from their CPU readings (port bf16: loss
#: 5e-5..5e-4, grad 1e-3..3e-3; port f32: under 1e-4 everywhere)
LIMITS = {("train", "bfloat16"): {"loss_gap": 2e-3, "grad_gap": 1e-2,
                                  "change_gap": 4e-2},
          ("prefill", "bfloat16"): {"logit_err": 0.05, "top_gap": 0.1},
          ("train", "float32"): {"loss_gap": 1e-4, "grad_gap": 1e-3,
                                 "change_gap": 1e-3},
          ("prefill", "float32"): {"logit_err": 1e-3, "top_gap": 1e-3}}
@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread while a test runs: the suite runs its files in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = {"dense": ("h2o-danube-3-4b", "dense_swa"),
         "moe": ("granite-moe-3b-a800m", "moe")}


def tiny(family: str, driver: str, dtype: str):
    from repro_torch import configs
    arch, ref = CELLS[family]
    pc = dataclasses.replace(configs.get_optimized_smoke_config(arch),
                             param_dtype=dtype, compute_dtype=dtype)
    c = dict(harness.describe(pc), reference=ref, rms_norm_eps=1e-6,
             router_aux_loss_coef=0.01)
    name = {"train": f"{arch}.train.1x{8192 if family == 'dense' else 4096}",
            "prefill": f"{arch}.prefill.b{1 if family == 'dense' else 4}"
            }[driver]
    cell = harness.load_cell(name, BENCH)
    t = dict(cell.t, check=dict(cell.t["check"],
                                limits=LIMITS[driver, dtype]))
    if driver == "train":
        t.update(seq_len=24, profile_steps=1)
    else:
        t.update(lengths=TINY_DECK, profile_round=0,
                 check={"calls": 3, "limits": LIMITS[driver, dtype]})
    return dataclasses.replace(cell, cfg=c, t=t), pc


def readings(family, driver, dtype, seed=7):
    cell, pc = tiny(family, driver, dtype)
    drv = harness.load_module("drivers", driver).Driver(
        harness.Ctx(cell, seed, torch.device("cpu"), pc))
    return cell, (controls.train_readings if driver == "train"
                  else controls.prefill_readings)(drv, True)


@pytest.mark.parametrize("family,driver,dtype,control", [
    ("dense", "train", "bfloat16", "fp8"),
    ("dense", "prefill", "bfloat16", "fp8"),
    ("moe", "train", "float32", "bf16"),
    ("moe", "prefill", "float32", "bf16")])
def test_port_passes_and_lower_precision_fails(family, driver, dtype,
                                               control, monkeypatch):
    # the control's precision stands in for the readings' "fp8"
    if control != "fp8":
        from portbench.reference import model as ref_model
        real = ref_model.RefModel.__init__

        def init(self, c, w, prec="f32"):
            real(self, c, w, control if prec == "fp8" else prec)
        monkeypatch.setattr(ref_model.RefModel, "__init__", init)
    cell, r = readings(family, driver, dtype)
    limits = cell.t["check"]["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["fp8"][k] > v for k, v in limits.items()), r


def _execute(cell, pc):
    return harness.execute(cell, 5, 0.2, False, "cpu", time.perf_counter(),
                           port_cfg=pc)


def _unchanged_state(monkeypatch):
    from repro_torch.parallel import steps

    def no_update(grads, opt_state, params, **kw):
        return params, opt_state, {"grad_norm": torch.zeros(())}
    monkeypatch.setattr(steps, "adamw_update", no_update)


def _half_batch_train(monkeypatch):
    from repro_torch.runtime import train_loop
    make = train_loop.make_train_step

    def halved(*a, **kw):
        step = make(*a, **kw)
        return lambda model, opt, batch, i: step(
            model, opt, {"tokens": controls.half_rows(batch["tokens"])}, i)
    monkeypatch.setattr(train_loop, "make_train_step", halved)


def _half_batch_prefill(monkeypatch):
    from repro_torch.models.model import Model
    prefill = Model.prefill

    def halved(self, batch, **kw):
        toks = batch["tokens"]
        logits, caches = prefill(self, {"tokens": controls.half_rows(toks)},
                                 **kw)
        reps = toks.shape[0] // logits.shape[0]
        return logits.repeat(reps, 1, 1), caches
    monkeypatch.setattr(Model, "prefill", halved)


def _token_altered(monkeypatch):
    from repro_torch.launch import serve
    generate = serve.generate

    def altered(model, batch, steps):
        out = generate(model, batch, steps)
        out["tokens"] = (out["tokens"] + 1) % model.cfg.vocab_size
        return out
    monkeypatch.setattr(serve, "generate", altered)


@pytest.mark.parametrize("driver,fault", [
    ("train", None), ("train", _unchanged_state),
    ("train", _half_batch_train),
    ("prefill", None), ("prefill", _half_batch_prefill),
    ("prefill", _token_altered)])
def test_a_broken_timed_path_is_not_correct(driver, fault, monkeypatch):
    cell, pc = tiny("dense", driver, "bfloat16")
    if fault is not None:
        fault(monkeypatch)
    out = _execute(cell, pc)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
