"""The multi-device layer on the card: the job moved between the card and
the host mid-run (``Trainer.resize``), at smoke size.

granite-moe-3b-a800m's smoke config trains on the card (the ``(1, 1)``
mesh of ``MeshRules``): in f32, a step on the card, a ``resize`` onto the
host, a step there on the plain versions, a ``resize`` back and a step on
the card must land within ``chip_smoke.py``'s ``F32_TRAIN_TOL`` loss bar
of three steps on the card, the state's bits unchanged by each move; in
bf16, two steps, a round trip through the host and two more steps must
give the losses of four steps on the card, bit for bit.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_parallel_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeCfg
from repro_torch.parallel import MeshRules
from repro_torch.runtime import Trainer

pytestmark = pytest.mark.gpu

ARCH = "granite-moe-3b-a800m"
SHAPE = ShapeCfg("smoke", 64, 4, "train")
#: chip_smoke.py's F32_TRAIN_TOL["loss"]: f32 sums in another order (the
#: host's plain versions) in one step of three
LOSS_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(tr) -> dict:
    """Every tensor of the state, as host copies of its bits."""
    ints = {2: torch.int16, 4: torch.int32}
    host = tr.host_state()
    out = {f"p.{n}": t for n, t in host["params"].items()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": t for n, t in host[k].items()})
    out["count"] = host["count"]
    return {n: t.reshape(-1).view(ints[t.element_size()]).clone()
            for n, t in out.items()}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def test_one_device_is_the_one_by_one_mesh(dev):
    rules = MeshRules(configs.get_smoke_config(ARCH), Trainer(
        configs.get_smoke_config(ARCH), SHAPE, dev).pcfg, dev)
    assert not rules.sharded and rules.axis_size == {"data": 1, "model": 1}


def test_f32_step_on_the_host_between_card_steps(dev):
    cfg = configs.get_smoke_config(ARCH)
    card = Trainer(cfg, SHAPE, dev, seed=0)
    card.init_state()
    want = card.run(3).losses
    tr = Trainer(cfg, SHAPE, dev, seed=0)
    tr.init_state()
    got = tr.run(1).losses
    before = _bits(tr)
    tr.resize("cpu")
    assert tr.device == torch.device("cpu") and tr.step == 1
    assert _same(_bits(tr), before)
    got += tr.run(1).losses
    before = _bits(tr)
    tr.resize(dev)
    assert tr.device == dev and tr.step == 2
    assert _same(_bits(tr), before)
    got += tr.run(1).losses
    assert got[0] == want[0]
    assert all(abs(a - b) <= LOSS_TOL for a, b in zip(got, want)), \
        (got, want)


def test_bf16_round_trip_is_bit_exact(dev):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    ref = Trainer(cfg, SHAPE, dev, seed=0)
    ref.init_state()
    want = ref.run(4).losses
    tr = Trainer(cfg, SHAPE, dev, seed=0)
    tr.init_state()
    got = tr.run(2).losses
    before = _bits(tr)
    tr.resize("cpu")
    tr.resize(dev)
    assert _same(_bits(tr), before)
    got += tr.run(2).losses
    assert got == want
