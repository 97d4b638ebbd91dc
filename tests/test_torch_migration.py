"""Live migration between the JAX package and its PyTorch port.

A launch paused at a barrier snapshots into a backend- and package-neutral
blob (``Snapshot.to_bytes``, format version 1).  A launch paused under the
reference interpreter resumes on the port's ``cuda`` backend (its plain
version on CPU tensors here), and the reverse, with bits equal to the zoo
oracle; specialized launches keep their specialization key across the
hop; and the README's driver-API migration example runs between two port
sessions.
"""
import numpy as np
import pytest
import torch

import repro.zoo  # noqa: F401
from repro.core import Engine as RefEngine
from repro.core import get_backend as ref_backend
from repro.core import kernels_suite as ref_ks
from repro.core.state import Snapshot as RefSnapshot

import repro_torch.zoo  # noqa: F401
from repro_torch.core import Engine, HetSession, get_backend, migrate
from repro_torch.core import hetir as ir
from repro_torch.core import kernels_suite as ks
from repro_torch.core.state import Snapshot


def _bits(a):
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _attn():
    prog, oracle, grid, block, args, outs = ref_ks.example_launch(
        "attn_decode", rng=np.random.default_rng(11))
    want = oracle({k: np.copy(v) if isinstance(v, np.ndarray) else v
                   for k, v in args.items()})["O"]
    return prog, grid, block, args, want


@pytest.mark.parametrize("pause", [1, 4])
def test_reference_interp_to_port_cuda(pause):
    prog, grid, block, args, want = _attn()
    src = RefEngine(prog, ref_backend("interp"), grid, block, dict(args))
    assert not src.run(max_segments=pause)     # paused mid-softmax
    snap = Snapshot.from_bytes(src.snapshot().to_bytes())
    dst = Engine.resume(ir.from_foreign(prog),
                        get_backend("cuda", device="cpu"), snap)
    assert dst.node_idx == src.node_idx
    assert dst.run()
    np.testing.assert_array_equal(_bits(dst.result("O")), _bits(want))


@pytest.mark.parametrize("pause", [2, 5])
def test_port_cuda_to_reference_interp(pause):
    prog, grid, block, args, want = _attn()
    src = Engine(ir.from_foreign(prog), get_backend("cuda", device="cpu"),
                 grid, block, dict(args))
    assert not src.run(max_segments=pause)
    snap = RefSnapshot.from_bytes(src.snapshot().to_bytes())
    dst = RefEngine.resume(prog, ref_backend("interp"), snap)
    assert dst.run()
    np.testing.assert_array_equal(_bits(dst.result("O")), _bits(want))


def test_specialized_launch_keeps_its_spec_key_across_packages():
    prog, _, grid, block, args, outs = ref_ks.example_launch(
        "dyn_matmul", rng=np.random.default_rng(3))
    whole = RefEngine(prog, ref_backend("interp"), grid, block, dict(args),
                      opt_level=3, specialize=True)
    assert whole.run()
    src = RefEngine(prog, ref_backend("interp"), grid, block, dict(args),
                    opt_level=3, specialize=True)
    assert src.spec_key
    assert not src.run(max_segments=3)
    snap = Snapshot.from_bytes(src.snapshot().to_bytes())
    assert snap.spec_key == tuple(tuple(e) for e in src.spec_key)
    dst = Engine.resume(ir.from_foreign(prog),
                        get_backend("cuda", device="cpu"), snap)
    assert dst.spec_key == tuple(tuple(e) for e in src.spec_key)
    assert ir.program_fingerprint(dst.program) == \
        ir.program_fingerprint(ir.from_foreign(src.program))
    assert dst.run()
    for o in outs:
        np.testing.assert_array_equal(_bits(dst.result(o)),
                                      _bits(whole.result(o)))


def test_readme_driver_api_migration_between_port_sessions():
    prog, oracle = ks.persistent_counter()
    src = HetSession("vectorized", device="cpu")
    dst = HetSession("cuda", device="cpu")
    counter = src.load(prog).function()
    dst.load(prog)
    state = src.alloc(64).copy_from_host(np.ones(64, np.float32))
    rec = counter.launch_async(grid=2, block=32,
                               args={"State": state, "iters": 6})
    src.step(3)                                 # 3 segments in, mid-loop
    new = migrate(rec, src, dst, "persistent_counter")
    assert dst.synchronize()
    got = new.buffer("State").copy_to_host()
    want = oracle({"State": np.ones(64, np.float32), "iters": 6})["State"]
    np.testing.assert_array_equal(got, want)
    assert new.buffer("State").uid == state.uid
    assert dst.stats["last_migration"]["payload_bytes"] > 0
    assert rec.cancelled


def test_session_defaults_to_the_card_and_refuses_without_one(tmp_path):
    if torch.cuda.is_available():
        assert HetSession().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HetSession()
    # the persistent tiers are ported: a session opens against them
    s = HetSession("interp", device="cpu", store=str(tmp_path / "store"),
                   shared=str(tmp_path / "fabric"))
    assert s.cache.store is not None and s.cache.shared is not None


@pytest.mark.parametrize("name", ["interp", "vectorized", "cuda"])
def test_backend_defaults_to_the_card_and_refuses_without_one(name):
    """``Engine(prog, get_backend(name), ...)`` is an entry point too: a
    backend made without a device is on ``cuda:0``, never silently on the
    CPU."""
    if torch.cuda.is_available():
        assert get_backend(name).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_backend(name)
    assert get_backend(name, device="cpu").device == torch.device("cpu")
