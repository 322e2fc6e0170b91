"""The fused engine's upload (TorchFwd.upload; on a card
io/device_preproc.PinnedStager): on the CPU `run_fwd` keeps the caller's
array as its input, as before the stager, and its upload span counts no
staged byte; a non-contiguous wire gives the contiguous one's outputs. The
tests that end in `_on_the_card` hold the pinned path on a card and skip
without one; this file imports no JAX, so they run there by themselves:
`python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_stager.py -q`.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from boda_tpu_torch.core.dims import NDA, Dims
from boda_tpu_torch.core.error import RtErr
from boda_tpu_torch.core.timers import global_timer_log
from boda_tpu_torch.engine.iface import make_engine
from boda_tpu_torch.io import device_preproc as dp
from boda_tpu_torch.models.zoo import build_model

WIRE_B128 = 128 * 224 * 224 * 3   # the cells' u8 batch, 19,267,584 B


def _arrays(rs):
    """Arrays of odd sizes and several dtypes, two of them non-contiguous
    views, one empty."""
    big = rs.randint(0, 256, (5, 7, 9, 3)).astype(np.uint8)
    return [rs.randint(0, 256, 1).astype(np.uint8),
            rs.randint(0, 256, (3, 5, 7, 3)).astype(np.uint8),
            rs.randn(13, 17).astype(np.float32),
            np.array(7, np.int32),
            np.zeros((0, 4), np.float32),
            big[:, ::-1, 1:8:2],
            rs.randn(11, 6).astype(np.float32).T]


def _wire_engine(dev: str, batch: int = 2, tune: str = "()"):
    """mini at `batch` behind the u8 wire, as the benchmark builds it."""
    pipe = build_model("mini", batch=batch)
    eng = make_engine(f"(engine=torch,device={dev},op_tune={tune})")
    eng.init(pipe)
    d = pipe.get_data_img_dims()
    wire = Dims.make(tn="uint8_t", img=batch, y=d["y"], x=d["x"], chan=3)
    eng.set_input_preproc("data", dp.device_preproc_fn(d["y"], d["x"]),
                          wire)
    return eng, wire


def _wire(batch: int, seed: int, hw: int = 32) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (batch, hw, hw, 3)).astype(np.uint8)


def test_run_fwd_on_the_cpu_keeps_the_callers_array():
    global_timer_log.clear()
    eng, wire = _wire_engine("cpu")
    assert eng._stager is None
    x = _wire(2, 1)
    inputs, staged = eng.upload({"data": NDA(wire, x)})
    assert inputs["data"].data_ptr() == x.ctypes.data   # no copy made
    assert staged == 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = eng.run_fwd({"data": NDA(wire, x)}, ["prob"])["prob"].v
    with torch.no_grad():
        want = eng.fwd({"data": torch.from_numpy(x)}, eng.weights,
                       out_nodes=["prob"])["prob"].numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape),
                                  strict=True)
    up = [s for s in global_timer_log.spans if s[0] == "run_fwd.upload"]
    assert [s[5] for s in up] == [{"bytes": x.nbytes, "staged": 0}]
    global_timer_log.clear()


@pytest.mark.parametrize("k", range(7))
def test_upload_on_the_cpu_gives_the_arrays_as_they_were(k):
    # what the upload gave before the stager: a 0-d array as (1,), a
    # non-contiguous one copied contiguous, an empty one empty
    eng, _wire_dims = _wire_engine("cpu")
    arr = _arrays(np.random.RandomState(k))[k]
    # the upload reads an NDA's array alone
    inputs, staged = eng.upload({"x": types.SimpleNamespace(v=arr)})
    want = np.ascontiguousarray(arr)
    assert staged == 0 and set(inputs) == {"x"}
    assert inputs["x"].dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(inputs["x"].numpy(), want, strict=True)


def test_run_fwd_takes_a_non_contiguous_input():
    eng, wire = _wire_engine("cpu")
    x = _wire(2, 2, hw=64)
    view = x[:, ::2, 1::2]   # (2, 32, 32, 3), strided
    assert not view.flags.c_contiguous
    got = eng.run_fwd({"data": NDA(wire, view)}, ["prob"])["prob"].v
    want = eng.run_fwd({"data": NDA(wire, np.ascontiguousarray(view))},
                       ["prob"])["prob"].v
    np.testing.assert_array_equal(got, want, strict=True)


# ----------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("the pinned upload runs on a card alone (run this file "
                    "there with --noconftest)")
    return torch.device("cuda", 0)


def test_staged_upload_is_bit_equal_on_the_card():
    dev = _card()
    st = dp.PinnedStager(dev)
    rs = np.random.RandomState(3)
    sizes = [1, 4097, 1 << 20, WIRE_B128 - 3, WIRE_B128 + 5]
    arrs = [rs.randint(0, 256, n).astype(np.uint8) for n in sizes] \
        + _arrays(rs)
    # uploads back to back, no sync between them: the buffer is reused
    # and grown while earlier copies may still be in flight
    outs = [(a, st.upload("x", a)) for a in arrs]
    for a, (got, staged) in outs:
        want = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
        assert staged == a.nbytes
    assert st._bufs["x"].is_pinned()
    assert st._bufs["x"].numel() == WIRE_B128 + 5


def test_uploads_from_many_threads_take_turns_on_the_card():
    # one key's buffer shared by more threads than cores: an upload that
    # read another's bytes would come back wrong
    dev = _card()
    st = dp.PinnedStager(dev)
    arrs = [np.full(1 << 20, k, np.uint8) for k in range(24)]
    bad = []

    def worker(a):
        for _ in range(20):
            got, _n = st.upload("data", a)
            if not bool((got == int(a[0])).all()):
                bad.append(int(a[0]))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(a,)) for a in arrs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert bad == []


def test_back_to_back_run_fwd_on_the_card():
    dev = _card()
    eng, wire = _wire_engine("cuda", batch=8, tune="(use_culibs=1)")
    xs = [_wire(8, s) for s in range(3)]

    def one_shot(x):
        with torch.no_grad():
            out = eng.fwd({"data": torch.from_numpy(x).to(dev)},
                          eng.weights, out_nodes=["prob"])["prob"]
        return out.cpu().numpy()
    want = [one_shot(x) for x in xs]

    def check(k):
        got = eng.run_fwd({"data": NDA(wire, xs[k])}, ["prob"])["prob"].v
        np.testing.assert_array_equal(got, want[k].reshape(got.shape),
                                      strict=True)
    for k in (0, 1, 2, 1, 0):
        check(k)
    # the span counts every byte as staged
    global_timer_log.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        check(1)
    up = [s[5] for s in global_timer_log.spans if s[0] == "run_fwd.upload"]
    assert up == [{"bytes": xs[1].nbytes, "staged": xs[1].nbytes}]
    global_timer_log.clear()
    # a larger wire grows the buffer and its forward raises (the input
    # check) with its copy possibly still in flight; the next call waits
    # for that copy before it writes the buffer
    big = _wire(16, 9)
    with pytest.raises(RtErr):
        eng.run_fwd({"data": NDA(Dims.make(tn="uint8_t", img=16, y=32, x=32,
                                           chan=3), big)}, ["prob"])
    assert eng._stager._bufs["data"].numel() == big.nbytes
    for k in (2, 0):
        check(k)
