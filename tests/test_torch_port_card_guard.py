"""Every kernel wrapper runs its library queries and its launches on the
card its tensors are on, with no card: `Kernel.launch` and `Kernel.query`
are replaced by stand-ins that note the device each call names, the
libraries by one that fails any call made around them, and the tensors
sit on the meta device, so nothing is computed. Each entry of kernels A,
A', A4, A4', B, C, D, D', E, E', F and F' (and the two `wgmma` probes and
C's slice query) must name its tensors' device at every query and launch,
and must raise before any of them when its tensors sit on two devices.
`Kernel.launch` and `Kernel.query` themselves are held to making that
device the current one (`torch.cuda.device`) around the C call.
"""

import functools

import pytest
import torch

from hyena_dna_tpu_torch import _cuda
from hyena_dna_tpu_torch.ops import add_ln as AL
from hyena_dna_tpu_torch.ops import fused_fftconv as FB
from hyena_dna_tpu_torch.ops import fused_front as FF
from hyena_dna_tpu_torch.ops import gated_fftconv as GE
from hyena_dna_tpu_torch.ops import mlp_fused as MF

KERNELS = [k for module in (AL, FB, FF, GE, MF) for k in vars(module).values()
           if isinstance(k, _cuda.Kernel)]
META = torch.device("meta")
F32, BF16 = torch.float32, torch.bfloat16


def t(*shape, dtype=F32):
    return torch.empty(shape, device=META, dtype=dtype)


def front(dtype, d_in=64, d=32, B=2, L=100):
    return t(B, L, d_in, dtype=dtype), t(d_in, 3 * d), t(3 * d), t(3, 3 * d), t(3 * d)


def conv(B=2, C=4, L=1000, dtype=F32):
    return t(B, C, L, dtype=dtype), t(C, L, dtype=dtype), t(C)


def spectrum(B=2, C=4, L=1000):
    return t(B, (C + 1) // 2, FB.next_fast_fft_size(2 * L), 2)


def mlp(n=64, d=64, dh=128, d_out=64, dtype=BF16):
    return t(n, d, dtype=dtype), t(d, dh), t(dh), t(dh, d_out), t(d_out)


# entry -> (call, kernels it launches); each call returns the wrapper's call
ENTRIES = {
    "A_f32": (lambda: (FF.front_fwd, front(F32)), {"fused_front"}),
    "A_bf16": (lambda: (FF.front_fwd, front(BF16)), {"fused_front"}),
    "A'_f32": (lambda: (FF.front_bwd, front(F32) + (t(2, 32, 100), t(2, 32, 100))),
               {"fused_front_bwd"}),
    "A'_bf16": (lambda: (FF.front_bwd, front(BF16) + (t(2, 32, 100, dtype=BF16),) * 2),
                {"fused_front_bwd"}),
    "A4_f32": (lambda: (lambda *a: FF.front4_fwd(*a, 2, 64), front(F32)), {"fused_front4"}),
    "A4'_f32": (lambda: (FF.front4_bwd, front(F32) + (t(2, 32, 2, 64),) * 2),
                {"fused_front4_bwd"}),
    "A4_bf16": (lambda: (lambda *a: FF.front4_fwd(*a, 2, 64), front(BF16)), {"fused_front4"}),
    "A4'_bf16": (lambda: (FF.front4_bwd, front(BF16) + (t(2, 32, 2, 64, dtype=BF16),) * 2),
                 {"fused_front4_bwd"}),
    "A_probe": (lambda: (lambda a, b: FF.wgmma_probe(a, b, 0), (t(64, 64, dtype=BF16),) * 2),
                {"fused_front"}),
    "B_short": (lambda: (FB.fftconv_fused, conv()), {"fftconv"}),
    "B_spectrum": (lambda: (lambda *a: FB.fftconv_fused(*a, save_spectrum=True), conv()),
                   {"fftconv"}),
    "C_retransform": (lambda: (lambda u, k, D, dy: FB.fftconv_bwd_retransform(u, dy, k, D),
                               conv() + (t(2, 4, 1000),)), {"fftconv_bwd"}),
    "C_spectrum": (lambda: (lambda u, k, D, s: FB.fftconv_bwd_spectrum(s, u, k, D),
                            conv() + (spectrum(),)), {"fftconv_bwd"}),
    "C_dk_spectrum": (lambda: (lambda u, dy: FB.fftconv_fused_dk_spec(u, dy, 16, 256, 1),
                               (t(2, 4, 2048), t(2, 4, 2048))), {"fftconv_bwd"}),
    "C_slices": (lambda: (lambda: FB.short_slices(2, 4, 2048, F32, META), ()), set()),
    "D": (lambda: (lambda h, r, w, b: AL.add_ln_fwd(h, r, w, b, 1e-5),
                   (t(8, 64, dtype=BF16), t(8, 64, dtype=BF16), t(64), t(64))), {"add_ln"}),
    "D'": (lambda: (lambda r, dy, dr, w: AL.add_ln_bwd(r, dy, dr, w, 1e-5),
                    (t(8, 64, dtype=BF16),) * 3 + (t(64),)), {"add_ln_bwd"}),
    "E": (lambda: (lambda u, k, D, x0: GE.fftconv_gated_fused(u, x0, k, D, True, True),
                   conv() + (t(2, 4, 1000),)), {"fftconv_gated"}),
    "E'_specv": (lambda: (lambda u, k, D, x0, s: GE.fftconv_gated_bwd_specv(s, u, u, x0, k, D),
                          conv() + (t(2, 4, 1000), spectrum())), {"fftconv_gated_bwd"}),
    "E'_spec": (lambda: (lambda u, k, D, x0, s: GE.fftconv_gated_bwd_spec(s, u, x0, k, D),
                         conv() + (t(2, 4, 1000), spectrum())), {"fftconv_gated_bwd"}),
    "E'_retransform": (lambda: (lambda u, k, D, x0: GE.fftconv_gated_bwd_retransform(
        u, u, x0, k, D), conv() + (t(2, 4, 1000),)), {"fftconv_gated_bwd"}),
    "F": (lambda: (MF.mlp_fused_fwd, mlp()), {"mlp_fused"}),
    "F_f32": (lambda: (MF.mlp_fused_fwd, mlp(dtype=F32)), {"mlp_fused"}),
    "F'": (lambda: (lambda x, w1, b1, w2, b2: MF.mlp_fused_bwd(x, t(64, 64, dtype=BF16), w1, b1,
                                                               w2), mlp()), {"mlp_fused_bwd"}),
    "F_probe": (lambda: (lambda a, b: MF.wgmma_probe(a, b, 0),
                         (t(64, 64, dtype=BF16), t(64, 256, dtype=BF16))), {"mlp_fused"}),
}


def _query_result(fn, args):
    """What the C helpers answer, in the shapes the wrappers accept."""
    if fn == "hyena_mlp_bwd_ws_numel":
        d, dh, d_out = args
        return d * dh + dh * d_out + dh
    return {"hyena_front_ws_numel": 64, "hyena_front_bwd_runs": 1}.get(fn, 2)


@pytest.fixture
def calls(monkeypatch):
    """The device each query and launch names, through stand-ins."""
    seen = []

    def launch(kernel, fn, *args, device):
        seen.append(("launch", kernel.name, fn, device))

    def query(kernel, fn, *args, device):
        seen.append(("query", kernel.name, fn, device))
        return _query_result(fn, args)

    def lib(kernel):
        raise AssertionError(f"{kernel.name}: a library call outside Kernel.launch / query")

    for kernel in KERNELS:  # on each instance: a test elsewhere may leave one set there
        monkeypatch.setattr(kernel, "launch", functools.partial(launch, kernel))
        monkeypatch.setattr(kernel, "query", functools.partial(query, kernel))
        monkeypatch.setattr(kernel, "lib", functools.partial(lib, kernel))
    monkeypatch.setattr(_cuda, "on_card", lambda tensor: True)
    monkeypatch.setattr(_cuda, "stream_handle", lambda tensor: None)
    return seen


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_wrapper_queries_and_launches_on_its_tensors_card(entry, calls):
    make, kernels = ENTRIES[entry]
    fn, args = make()
    fn(*args)
    assert calls and {device for *_, device in calls} == {META}, calls
    assert {name for kind, name, _, _ in calls if kind == "launch"} == kernels
    assert any(kind == ("launch" if kernels else "query") for kind, *_ in calls)


@pytest.mark.parametrize("entry", sorted(set(ENTRIES) - {"C_slices"}))
def test_wrapper_refuses_tensors_on_two_devices(entry, calls):
    """The second tensor argument on the CPU, the rest on the meta device:
    the wrapper raises before it queries or launches anything."""
    make, _ = ENTRIES[entry]
    fn, args = make()
    args = (args[0], torch.empty_like(args[1], device="cpu")) + tuple(args[2:])
    with pytest.raises(ValueError):
        fn(*args)
    assert calls == []


class Library:
    """A kernel's library: each C function answers 0 (or `rc`) and notes the
    device current when it is called."""

    def __init__(self, current, rc=0):
        self.current, self.rc, self.calls = current, rc, []

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args, self.current[-1] if self.current else None))
            return self.rc
        return call


@pytest.fixture
def current(monkeypatch):
    """`torch.cuda.device` as a stand-in keeping a stack of current devices."""
    stack = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            stack.append(self.device)

        def __exit__(self, *exc):
            stack.pop()
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    return stack


@pytest.mark.parametrize("method", ["launch", "query"])
def test_kernel_calls_c_under_the_named_device(method, current, monkeypatch):
    """The C call runs with `device` current and the device before it
    current again after; a launch is counted, a query is not."""
    kernel, card = _cuda.Kernel("add_ln", {}), torch.device("cuda", 1)
    library = Library(current)
    monkeypatch.setattr(kernel, "lib", lambda: library)
    answer = getattr(kernel, method)("hyena_fn", 3, 4, device=card)
    assert library.calls == [("hyena_fn", (3, 4), card)] and current == []
    assert kernel.launches == (method == "launch")
    assert answer in (None, 0)


def test_failed_launch_raises_and_leaves_the_device(current, monkeypatch):
    kernel = _cuda.Kernel("add_ln", {})
    monkeypatch.setattr(kernel, "lib", lambda: Library(current, rc=700))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.launch("hyena_fn", device=torch.device("cuda", 1))
    assert current == [] and kernel.launches == 0


def test_kernel_calls_need_a_device():
    """`device` has no default: a launch or a query names its card."""
    kernel = _cuda.Kernel("add_ln", {})
    for method in (kernel.launch, kernel.query):
        with pytest.raises(TypeError):
            method("hyena_fn", 1)
