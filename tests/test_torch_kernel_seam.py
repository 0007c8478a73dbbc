"""The one seam through which the kernel wrappers of dfc_sa_unet_torch/ops call a kernel (ops/_build.py).

* ``ops.launches()`` shows the one counter, ``_build.LAUNCHES``: the sixteen names below, each set
  to 0 by ``reset_launches()``.
* Every wrapper's launch, driven on the CPU with the seam's device rules and its kernel lookup
  replaced (``on_cpu`` false, ``check_operands`` a no-op, ``kernel`` a recorder), calls an entry
  point of ``SIGNATURES`` with the argument count and kinds its ctypes signature gives, and counts
  under names the counter declares; together the wrappers reach every name.
* ``PlainBackward``, the autograd Function of the kernels, gives the plain version's gradients and
  only to the inputs that need one.
* No module of ops/ but _build.py looks a kernel up, passes a stream or touches a counter.
"""

import ast
import ctypes
import pathlib

import pytest
import torch

from dfc_sa_unet_torch.ops import _build, launches, reset_launches
from dfc_sa_unet_torch.ops.bias_add import bias_add
from dfc_sa_unet_torch.ops.conv_bn_stats import conv3x3_bias_stats
from dfc_sa_unet_torch.ops.conv_s8 import conv3x3_s8
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, dfc_tail
from dfc_sa_unet_torch.ops.layer_norm import layer_norm
from dfc_sa_unet_torch.ops.lsa_epilogue import lsa_epilogue
from dfc_sa_unet_torch.ops.mha import fused_mha, fused_mha_sep
from dfc_sa_unet_torch.ops.mxu_probes import probe_conv_9dot, probe_conv_cat, probe_matmul
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention

torch.set_num_threads(2)
OPS = pathlib.Path(__file__).resolve().parent.parent / "dfc_sa_unet_torch" / "ops"
COUNTED = ["pooled_attention", "conv3x3_bn_relu", "dfc_tail", "fused_mha", "fused_mha_sep", "conv3x3_bias_stats",
           "probe_matmul", "probe_conv_cat", "probe_conv_9dot", "conv3x3_s8", "lsa_epilogue", "bias_add",
           "layer_norm", "pooled_attention.fewer_queries", "pooled_attention.more_queries", "pooled_attention.rel_pos"]
BF, F32, S8 = torch.bfloat16, torch.float32, torch.int8


def test_launches_shows_the_one_counter_and_reset_zeros_it():
    assert list(launches()) == COUNTED
    for name in COUNTED:
        _build.LAUNCHES[name] += 2
    assert set(launches().values()) == {2}
    reset_launches()
    assert launches() == dict.fromkeys(COUNTED, 0)
    launches()["dfc_tail"] = 5  # a copy: the counter is not written through it
    assert launches()["dfc_tail"] == 0


def _t(*shape, dtype=F32):
    g = torch.Generator().manual_seed(sum(shape))
    if dtype == S8:
        return torch.randint(-127, 128, shape, generator=g, dtype=S8)
    return torch.randn(*shape, generator=g).to(dtype)


def _tail_args(dtype, cin=3, c=32, h=4, w=5):
    return (_t(1, h, w, cin, dtype=dtype), _t(1, h, w, c, dtype=dtype), _t(3, 3, cin, c, dtype=dtype), _t(c),
            _t(2 * c, c, dtype=dtype), _t(c), _t(3 * c, c, dtype=dtype), _t(c), _t(cin, c, dtype=dtype))


def _halo(cin, dtype, w=5):
    return {"top": _t(1, w, cin, dtype=dtype), "bottom": None}


# (label, call, the entry point, the counted names)
CALLS = [
    ("attention_f32", lambda: pooled_attention(_t(2, 4, 4, 8), _t(2, 4, 4, 8), _t(2, 4, 4, 16)),
     "pooled_attention_f32", ["pooled_attention"]),
    ("attention_bf16_more_queries", lambda: pooled_attention(_t(2, 64, 2 * 12, dtype=BF), _t(2, 8, 2 * 12, dtype=BF),
                                                             _t(2, 8, 2 * 20, dtype=BF), 2),
     "pooled_attention_wgmma_bf16", ["pooled_attention", "pooled_attention.more_queries"]),
    ("attention_bf16_rel_pos", lambda: pooled_attention(_t(2, 16, 2 * 64, dtype=BF), _t(2, 16, 2 * 64, dtype=BF),
                                                        _t(2, 16, 2 * 64, dtype=BF), 2, _t(2, 16, 2, 4, dtype=BF),
                                                        _t(2, 16, 2, 4, dtype=BF)),
     "pooled_attention_relpos_bf16", ["pooled_attention", "pooled_attention.rel_pos"]),
    ("attention_long_fewer_queries", lambda: pooled_attention(_t(1, 8, 16, 8), _t(1, 16, 16, 8), _t(1, 16, 16, 8)),
     "pooled_attention_long_f32", ["pooled_attention", "pooled_attention.fewer_queries"]),
    ("tail_f32", lambda: dfc_tail(*_tail_args(F32)), "dfc_tail_f32", ["dfc_tail"]),
    ("tail_bf16_halo", lambda: dfc_tail(*_tail_args(BF), **_halo(3, BF)), "dfc_tail_halo_bf16", ["dfc_tail"]),
    ("conv_bf16", lambda: conv3x3_bn_relu(_t(1, 4, 5, 3, dtype=BF), _t(3, 3, 3, 16, dtype=BF), _t(16)),
     "conv3x3_bn_relu_bf16", ["conv3x3_bn_relu"]),
    ("conv_f32_halo", lambda: conv3x3_bn_relu(_t(1, 4, 5, 8), _t(3, 3, 8, 16), _t(16), **_halo(8, F32)),
     "conv3x3_bn_relu_halo_f32", ["conv3x3_bn_relu"]),
    ("mha", lambda: fused_mha(_t(2, 9, 3 * 32, dtype=BF), 2), "mha_wgmma_bf16", ["fused_mha"]),
    ("mha_sep", lambda: fused_mha_sep(_t(2, 9, 32), _t(2, 9, 32), _t(2, 9, 32), 4), "mha_f32", ["fused_mha_sep"]),
    ("stats_bf16", lambda: conv3x3_bias_stats(_t(1, 4, 5, 3, dtype=BF), _t(3, 3, 3, 16, dtype=BF), _t(16)),
     "conv3x3_bias_stats_bf16", ["conv3x3_bias_stats"]),
    ("stats_f32", lambda: conv3x3_bias_stats(_t(1, 4, 5, 8), _t(3, 3, 8, 16), _t(16)),
     "conv3x3_bias_stats_f32", ["conv3x3_bias_stats"]),
    ("probe_matmul", lambda: probe_matmul(_t(16, 8, dtype=BF), _t(8, 16, dtype=BF)), "probe_matmul_bf16",
     ["probe_matmul"]),
    ("probe_conv_cat", lambda: probe_conv_cat(_t(1, 4, 4, 8, dtype=BF), _t(3, 24, 8, dtype=BF)),
     "probe_conv_cat_bf16", ["probe_conv_cat"]),
    ("probe_conv_9dot", lambda: probe_conv_9dot(_t(1, 4, 4, 8, dtype=BF), _t(9, 8, 8, dtype=BF)),
     "probe_conv_9dot_bf16", ["probe_conv_9dot"]),
    ("s8_halo", lambda: conv3x3_s8(_t(1, 4, 5, 24, dtype=S8), _t(16, 9 * 24, dtype=S8), _t(16), _t(16),
                                   torch.float32, **_halo(24, S8)), "conv3x3_s8_halo_f32", ["conv3x3_s8"]),
    ("lsa_epilogue", lambda: lsa_epilogue(_t(2, 8, 8, 16, dtype=BF), _t(2, 4, 4, 16, dtype=BF), _t(1)),
     "lsa_epilogue_bf16", ["lsa_epilogue"]),
    ("bias_add", lambda: bias_add(_t(4, 6, 32, dtype=BF), _t(32)), "bias_add_bf16", ["bias_add"]),
    ("layer_norm", lambda: layer_norm(_t(4, 6, 64, dtype=BF), _t(64), _t(64), 1e-6), "layer_norm_bf16",
     ["layer_norm"]),
]


@pytest.fixture
def recorded(monkeypatch):
    """The seam with its device rules and its kernel lookup replaced: every launch is recorded as
    (entry point, arguments) and returns no error."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(_build, "check_operands", lambda *args, **kwargs: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "kernel", lambda entry: lambda *args: calls.append((entry, args)) or 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))  # bias_add's own rule
    reset_launches()
    yield calls
    reset_launches()


@pytest.mark.parametrize("label,call,entry,counted", CALLS, ids=[c[0] for c in CALLS])
def test_each_wrapper_launches_through_the_seam(recorded, label, call, entry, counted):
    call()
    assert [e for e, _ in recorded] == [entry]
    argtypes = _build.SIGNATURES[entry][1]
    args = recorded[0][1]
    assert len(args) == len(argtypes), (entry, args)
    for arg, kind in zip(args, argtypes):
        assert (isinstance(arg, int) or (kind is ctypes.c_void_p and arg is None)
                or (kind is ctypes.c_float and isinstance(arg, float))), (entry, args)
    assert {k: v for k, v in launches().items() if v} == dict.fromkeys(counted, 1)


def test_the_wrappers_reach_every_counted_name():
    assert {name for *_, counted in CALLS for name in counted} == set(COUNTED)
    assert {entry for _, _, entry, _ in CALLS} <= set(_build.SIGNATURES)


def test_plain_backward_gives_the_plain_versions_gradients_where_needed():
    """A plain forward patched in for the kernel: the Function's gradients are autograd's through the
    plain version, for the inputs that need one (None for the others), contiguous."""
    def plain(a, b, c, scale):
        return (a @ b).softmax(-1) * c * scale

    a, b, c = _t(3, 4, 5), _t(3, 5, 6), _t(3, 4, 6)
    a.requires_grad_(True)
    c.requires_grad_(True)
    seen = []

    def launch(*args):
        seen.append(torch.is_grad_enabled())
        return plain(*args)

    out = _build.PlainBackward.apply(launch, plain, (0.5,), a, b, c)
    weight = _t(3, 6, 4).transpose(1, 2)  # a non-contiguous upstream gradient
    (out * weight).sum().backward()
    assert seen == [False]  # the forward ran once, outside autograd
    ga, gc = torch.autograd.grad((plain(a, b, c, 0.5) * weight).sum(), (a, c))
    assert torch.equal(a.grad, ga) and torch.equal(c.grad, gc)
    assert b.grad is None and a.grad.is_contiguous() and c.grad.is_contiguous()


def test_only_the_seam_looks_kernels_up_and_counts_launches():
    """No module of ops/ but _build.py reaches ``kernel``, ``check``, ``stream_handle`` or ``LAUNCHES``
    of the seam, or keeps a counter of its own (a module-level dict whose values are launch counts)."""
    private = {"kernel", "check", "stream_handle", "LAUNCHES"}
    bad = []
    for path in sorted(OPS.glob("*.py")):
        if path.name == "_build.py":
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in private:
                bad.append((path.name, node.lineno, node.attr))
            elif isinstance(node, ast.ImportFrom) and node.module and node.module.endswith("_build"):
                bad += [(path.name, node.lineno, a.name) for a in node.names if a.name in private]
            elif isinstance(node, ast.Name) and node.id in private:
                bad.append((path.name, node.lineno, node.id))
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
                bad.append((path.name, node.lineno, ast.unparse(node)))
    assert not bad, bad
