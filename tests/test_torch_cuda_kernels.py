"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper GPU and nvcc: a CUDA kernel has no CPU
mode, so on a machine without a card they skip. On the card run them
without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

Tolerances: K1 reads bf16 operands, and both sides get the same
bf16-rounded values, so what differs is f32 summation order, the online
softmax's rescaling and the probabilities' hi + lo bf16 split (2^-17
relative): 1e-4 on outputs of O(1). K2 is f32 throughout (its projection on
the tensor cores from TF32 hi + lo operands, 2^-21 relative); its sums run
in another order than cuBLAS's, carried through T steps: 1e-4.
The backwards sum over many more terms (K1's dk/dv over all B*L query
rows, K2's weight gradients over T*B), K1's with dS and P as hi + lo bf16
pairs and K2's and K3's products as 3xTF32 on the tensor cores in K slices
of at most 2304: their tolerance is 1e-4 relative to the largest gradient. Backward results must repeat bit for bit. K3 and K6
are f32 recurrences like K2 (1e-4); with bf16 streams both sides read the
same bf16-rounded values, and K3's bf16 stream gradients may differ from the
plain version's by one bf16 rounding (2^-8 relative) where the f32 values
differ in round-off: 1e-2 of the largest. K4 and K5 read bf16 operands and
both sides get the same bf16-rounded values. K5's results are f32 and the
probabilities and dS enter its tensor-core products as hi + lo bf16 pairs:
1e-4 on outputs of O(1), 1e-4 relative on gradients. K4's results leave the
kernel in bf16, so they carry one bf16 rounding: 1e-2 of the largest.
The two backwards share one algorithm; their CPU emulations
(`tiled_fused_attention_bwd`, `register_block_attention_bwd`) run here on
the card's tensors in f32: K5's gradients agree with them to 1e-5 relative
(what is left is the order of f32 sums inside an mma), K4's to within one
bf16 rounding (2^-8) of each element beyond that.
"""

import pytest
import torch

from hop_tpu_torch.ops import _build
from hop_tpu_torch.ops import attention as K4
from hop_tpu_torch.ops import block_attention as K5
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_seq as K6
from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.ops import reprogramming_attention as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L,H,S", [
    (3, 34, 2, 65),        # S split across blocks, a one-key last tile
    (5, 17, 1, 200),       # a ragged row tile, 4 key splits
    (3, 100, 2, 40),       # L above 68, rows of one sample in two tiles, S < a tile
    (40, 70, 8, 100),      # one split, L not dividing the row tile
    (1, 34, 8, 1500),      # one window of a clip: 12 key splits
    (256, 34, 8, 1500),    # the HOP serving shape
    (128, 34, 8, 1500),    # a rank's rows of it at data = 2
    (64, 34, 8, 1500),     # and at data = 4
])
def test_reprogramming_attention_kernel(device, B, L, H, S, rate):
    g = torch.Generator(device=device).manual_seed(B + S)
    q = torch.randn(B, L, H, 128, device=device, generator=g)
    k = torch.randn(H, S, 128, device=device, generator=g)
    v = torch.randn(H, S, 128, device=device, generator=g)
    before = K1.launches
    got, lse = K1.reprogramming_attention_fwd(q, k, v, 128 ** -0.5, rate, 7,
                                              with_lse=True)
    again = K1.reprogramming_attention_fwd(q, k, v, 128 ** -0.5, rate, 7)
    torch.cuda.synchronize()
    assert K1.launches == before + 2
    assert torch.equal(got, again)
    want, want_lse = K1.plain_reprogramming_attention(
        *(t.to(torch.bfloat16).float() for t in (q, k, v)), 128 ** -0.5, rate, 7,
        with_lse=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_residuals", [False, True])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [
    (5, 11, 20, 40),        # ragged batch tile, W_hh in shared memory
    (6, 9, 13, 10),         # widths that allow no 16- or 8-byte copies
    (28, 256, 8, 64),       # the discriminator's first layer: one k-step
    (28, 1, 128, 64),       # its upper layers at one sample
    (34, 1, 992, 350),      # one window of a clip: the cluster's one-row-tile instance
    (34, 9, 700, 350),      # just above it: one cluster of five row tiles
    (7, 13, 20, 100),       # one block, a width that is no multiple of 8
    (6, 43, 24, 203),       # a cluster of slices of 26 units, the last short
    (34, 256, 992, 350),    # the HOP head's first layer
    (34, 128, 992, 350),    # a rank's rows of it at data = 2
    (34, 64, 992, 350),     # and at data = 4
    (34, 256, 1751, 350),   # the same on TED Expressive: folded 1-float projection
    (34, 256, 96, 300),     # the hierarchy's stages 1-2, TED
    (34, 256, 102, 300),
    (34, 256, 105, 300),    # its stages 1-5, Expressive
    (34, 256, 111, 300),
    (34, 256, 117, 300),
    (34, 256, 147, 300),
    (34, 256, 177, 300),
    (34, 256, 108, 300),    # PoseGenerator's first layer, TED: slices of 38 units
    (34, 256, 207, 300),    # the same, Expressive: an input width no multiple of 8
    (34, 256, 600, 300),    # the zoo's upper layers at H = 300
    (36, 256, 300, 300),    # the seq2seq encoder's first layer (36 words)
    (34, 256, 64, 256),     # ContextEncoder's first layer (one direction in the net)
    (34, 256, 256, 256),    # its second layer
])
def test_gru_fused_kernel(device, D, T, B, I, H, with_residuals):
    g = torch.Generator(device=device).manual_seed(D * 100 + I)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=g) * scale
    s = H ** -0.5
    args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(D, 3, H, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(B, H, scale=0.5))
    before = K2.launches
    got = K2.gru_fused_layer_fwd(*args, with_residuals=with_residuals)
    again = K2.gru_fused_layer_fwd(*args, with_residuals=with_residuals)
    torch.cuda.synchronize()
    assert K2.launches == before + 2
    want = K2.plain_gru_fused_layer(*args, with_residuals=with_residuals)
    if not with_residuals:
        got, again, want = (got,), (again,), (want,)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)


def _rel_close(got, want, rel=1e-4, name=""):
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    assert err <= rel * scale, f"{name}: max abs err {err} > {rel} * {scale}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L,H,S", [
    (3, 34, 2, 65),        # ragged row tile (B * L = 102) and a one-key last tile
    (3, 100, 2, 65),       # a sample's rows in two row tiles; 5 row runs
    (5, 17, 1, 200),       # one head, B * L = 85, S = 3 tiles + 8 keys
    (40, 70, 8, 100),      # 44 row chunks in 15 runs of 3, the last run ragged
    (1, 34, 8, 1500),      # one window of a clip: one row chunk, one run
    (250, 34, 8, 1500),    # a ragged last row tile at full size
    (256, 34, 8, 1500),    # the HOP training shape: 4 row runs
    (128, 34, 8, 1500),    # a rank's rows of it at data = 2
    (64, 34, 8, 1500),     # and at data = 4
])
def test_reprogramming_attention_bwd_kernel(device, B, L, H, S, rate):
    g = torch.Generator(device=device).manual_seed(B + S)
    q, do = (torch.randn(B, L, H, 128, device=device, generator=g) for _ in range(2))
    k, v = (torch.randn(H, S, 128, device=device, generator=g) for _ in range(2))
    q, k, v, do = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
    scale, seed = 128 ** -0.5, 77
    out, lse = K1.reprogramming_attention_fwd(q, k, v, scale, rate, seed, True)
    want_out, want_lse = K1.plain_reprogramming_attention(q, k, v, scale, rate,
                                                          seed, True)
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    before = K1.bwd_launches
    got = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, scale, rate, seed)
    again = K1.reprogramming_attention_bwd(q, k, v, out, lse, do, scale, rate, seed)
    torch.cuda.synchronize()
    assert K1.bwd_launches == before + 2
    want = K1.plain_reprogramming_attention_bwd(q, k, v, want_out, want_lse, do,
                                                scale, rate, seed)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        _rel_close(a, c, name=name)


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,B,I,H", [
    (5, 11, 20, 40),        # ragged batch tile, one K slice
    (6, 9, 13, 10),         # widths that allow no 16- or 8-byte copies
    (7, 33, 8, 64),         # I = 8: a product 8 rows tall on a 64 x 64 tile
    (9, 70, 130, 131),      # I and H just above a tile, not multiples of 8
    (28, 256, 8, 64),       # the discriminator's first layer: 28 K slices
    (28, 256, 128, 64),     # the discriminator's upper layers
    (6, 43, 24, 203),       # the carry through a cluster, ragged slices and rows
    (34, 1, 700, 350),      # one sample: the cluster's one-row-tile instance
    (34, 250, 700, 350),    # a ragged last row tile at the head's width
    (34, 256, 992, 350),    # the HOP head's first layer: 128 x 128 tiles
    (34, 128, 992, 350),    # a rank's rows of it at data = 2
    (34, 64, 992, 350),     # and at data = 4
    (34, 256, 1751, 350),   # the same on TED Expressive: an odd K of 1751
    (34, 256, 96, 300),     # the hierarchy's stages 1-2 (TED) and 1-5
    (34, 256, 102, 300),    # (Expressive)
    (34, 256, 105, 300),
    (34, 256, 111, 300),
    (34, 256, 117, 300),
    (34, 256, 147, 300),
    (34, 256, 177, 300),
    (34, 256, 108, 300),    # the baseline zoo's layers (PoseGenerator, TED and
    (34, 256, 207, 300),    # Expressive; upper layers; the seq2seq encoder;
    (34, 256, 600, 300),    # ContextEncoder's two layers)
    (36, 256, 300, 300),
    (34, 256, 64, 256),
    (34, 256, 256, 256),
])
def test_gru_fused_bwd_kernel(device, D, T, B, I, H):
    gen = torch.Generator(device=device).manual_seed(D * 100 + I)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=gen) * scale
    s = H ** -0.5
    args = (arr(T, B, I, scale=1.0), arr(D, 3, I, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(D, 3, H, H, scale=s),
            arr(D, 3, 1, H, scale=s), arr(B, H, scale=0.5))
    g = arr(D, T, B, H, scale=1.0)
    h_seq, r, z, n, hnb = K2.gru_fused_layer_fwd(*args, with_residuals=True)
    want_res = K2.plain_gru_fused_layer(*args, with_residuals=True)
    for a, b in zip((h_seq, r, z, n, hnb), want_res):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    hprev = K2.hprev_of(h_seq, args[5])
    bwd_args = (g, args[0], r, z, n, hnb, hprev, args[1], args[3])
    before = K2.bwd_launches
    assert (K2.bwd_workspace_floats(T, B, I, H, D)
            == _build.load().hop_gru_fused_bwd_workspace(T, B, I, H, D))
    got = K2.gru_fused_layer_bwd(*bwd_args)
    again = K2.gru_fused_layer_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert K2.bwd_launches == before + 2
    want = K2.plain_gru_fused_layer_bwd(*bwd_args)
    for name, a, b, c in zip(("dx", "dwih", "dbih", "dwhh", "dbhh", "dh0"),
                             got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        _rel_close(a, c, name=name)


def _k3_args(device, D, T, B, H, dtype, seed):
    """Streams as strided views of one (T, B, D, 3, H) product, as the GRU
    module hands them over."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=gen) * scale
    s = H ** -0.5
    proj = arr(T, B, D, 3, H, scale=1.0).to(dtype)
    streams = [g.permute(2, 0, 1, 3) for g in proj.unbind(dim=3)]
    return (*streams, arr(D, 3, H, H, scale=s), arr(D, 3, 1, H, scale=s),
            arr(B, H, scale=0.5)), arr(D, T, B, H, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,T,B,H", [
    (2, 5, 11, 40),         # ragged batch tile
    (1, 28, 250, 64),       # one direction, the discriminator's width
    (2, 7, 13, 100),        # forward in one block, backward in a cluster
    (2, 6, 43, 203),        # both in a cluster, slices of 26 units, ragged rows
    (2, 34, 1, 350),        # one window of a clip: one row tile a cluster
    (2, 34, 8, 350),        # the widest batch of that instance
    (1, 34, 250, 350),      # one direction, a ragged last row tile
    (2, 34, 256, 350),      # the HOP head
    (2, 34, 256, 300),      # the baseline zoo's BiGRU(300) layers
    (2, 36, 256, 300),      # the seq2seq encoder (36 words)
    (1, 34, 256, 256),      # ContextEncoder's GRU(256), one direction
])
def test_gru_stack_kernels(device, D, T, B, H, dtype):
    args, g = _k3_args(device, D, T, B, H, dtype, seed=D * 100 + H)
    before = (K3.launches, K3.lean_launches, K3.bwd_launches)
    lean = K3.gru_stack(*args)
    fwd = K3.gru_stack_fwd(*args, with_residuals=True)
    want_fwd = K3.plain_gru_stack(*args, with_residuals=True)
    assert torch.equal(lean, fwd[0])
    for a, b in zip(fwd, want_fwd):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    h_seq, r, z, n, hnb = fwd
    bwd_args = (g, r, z, n, hnb, K2.hprev_of(h_seq, args[5]), args[3], dtype)
    got = K3.gru_stack_bwd(*bwd_args)
    again = K3.gru_stack_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert (K3.launches, K3.lean_launches, K3.bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    want = K3.plain_gru_stack_bwd(*bwd_args)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for name, a, b, c in zip(("dxr", "dxz", "dxn", "dw", "db", "dh0"),
                             got, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        assert a.dtype == c.dtype and a.shape == c.shape, name
        _rel_close(a.float(), c.float(), rel if name.startswith("dx") else 1e-4,
                   name=name)


@pytest.mark.parametrize("H", [10, 64, 65, 138, 139, 203, 256, 300, 350, 352])
def test_recurrence_variant_is_the_kernels_choice(device, H):
    """The wrappers' copy of the host side's rule, one for the forward and
    the backward: clusters only where the rule says "cluster", and then
    enough of them at once for a bs-256 launch of both directions to be one
    wave."""
    lib = _build.load()
    variant = lib.hop_gru_recurrence_variant(H)
    assert ("block", "cluster")[variant] == K2.recurrence_variant(H)
    for backward in (False, True):
        held = lib.hop_gru_active_clusters(H, int(backward))
        if K2.recurrence_variant(H) == "block":
            assert held == 0
        else:
            assert held >= 2 * -(-256 // K2.CLUSTER_ROWS), held


@pytest.mark.parametrize("B", [1, 8, 9, 250, 256])
def test_forward_cluster_rows_are_the_kernels_choice(device, B):
    """Rows of a forward cluster, a function of (B, D) alone: the wrapper's
    copy against the C entry, and a bs-256 launch at one direction fits the
    clusters the card holds at once."""
    lib = _build.load()
    for D in (1, 2):
        assert lib.hop_gru_fwd_cluster_rows(B, D) == K2.forward_cluster_rows(B, D)
    rows = K2.forward_cluster_rows(256, 1)
    assert -(-256 // rows) <= lib.hop_gru_active_clusters(350, 0)


def _kernel_names(fn):
    """The names of the kernels one call of fn() launches (torch.profiler)."""
    from hop_tpu_torch.cli.time_kernels import kernel_ms_by_name
    names = kernel_ms_by_name(fn, n=4)
    assert names, "torch.profiler recorded no whole window"
    return " ".join(names)


@pytest.mark.parametrize("D", [1, 2])
def test_narrow_forward_runs_the_one_block_kernel(device, D):
    """At the discriminator's shape (T=28, H=64) K2's second phase and K3's
    forwards launch the one-block tensor-core forward; at the head's width
    the cluster. K6 likewise at H=64 and H=350."""
    T, B, I, H = 28, 256, 8, 64
    gen = torch.Generator(device=device).manual_seed(D)

    def arr(*shape, scale=0.3):
        return torch.randn(*shape, device=device, generator=gen) * scale
    layer = (arr(T, B, I), arr(D, 3, I, H), arr(D, 3, 1, H), arr(D, 3, H, H),
             arr(D, 3, 1, H), arr(B, H))
    for with_res in (False, True):
        names = _kernel_names(lambda: K2.gru_fused_layer_fwd(*layer,
                                                             with_residuals=with_res))
        assert "gru_fwd_block_kernel" in names and "cluster" not in names, names
    stack, _ = _k3_args(device, D, T, B, H, torch.float32, seed=D)
    for with_res in (False, True):
        names = _kernel_names(lambda: K3.gru_stack_fwd(*stack, with_residuals=with_res))
        assert "gru_fwd_block_kernel" in names and "cluster" not in names, names
    for H, kernel in ((64, "gru_fwd_block_kernel"), (350, "gru_fwd_cluster_kernel")):
        seq = (arr(B, 34, 3 * H), arr(3 * H, H, scale=H ** -0.5), arr(3 * H),
               arr(B, H))
        names = _kernel_names(lambda: K6.gru_seq_layer(*seq, reverse=D == 2))
        assert kernel in names, names


def test_gru_kernels_refuse_a_layer_too_wide(device):
    H = K2.MAX_H + 1
    z = torch.zeros
    with pytest.raises(ValueError):
        K2.gru_fused_layer_fwd(z(2, 1, 4, device=device), z(1, 3, 4, H, device=device),
                               z(1, 3, 1, H, device=device), z(1, 3, H, H, device=device),
                               z(1, 3, 1, H, device=device), z(1, H, device=device))
    with pytest.raises(ValueError):
        K3.gru_stack_fwd(*(z(1, 2, 1, H, device=device) for _ in range(3)),
                         z(1, 3, H, H, device=device), z(1, 3, 1, H, device=device),
                         z(1, H, device=device))
    before = K6.launches
    with pytest.raises(ValueError, match="H <= 352"):
        K6.gru_seq_layer(z(2, 3, 3 * H, device=device), z(3 * H, H, device=device),
                         z(3 * H, device=device), z(2, H, device=device))
    assert K6.launches == before
    lib = _build.load()
    assert lib.hop_gru_active_clusters(H, 0) < 0
    assert lib.hop_gru_recurrence_variant(H) < 0


def test_gru_stack_trains_through_the_kernels(device):
    """The autograd Function on the card against autograd of the plain
    forward: every operand's gradient."""
    args, g = _k3_args(device, 2, 9, 13, 48, torch.float32, seed=3)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    got = torch.autograd.grad(K3.gru_stack(*leaves), leaves, g)
    want = torch.autograd.grad(K3.plain_gru_stack(*leaves), leaves, g)
    for name, a, b in zip(("dxr", "dxz", "dxn", "dw", "db", "dh0"), got, want):
        _rel_close(a, b, name=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [
    (11, 5, 40),            # one block, a ragged tile
    (256, 28, 64),          # the widest one-block layer
    (1, 34, 64),
    (1, 34, 350),           # one window of a clip: one row tile a cluster
    (8, 34, 350),           # the widest batch of that instance
    (9, 34, 350),           # just above it
    (250, 34, 350),         # a ragged last row tile
    (256, 34, 350),         # the head's layer
    (9, 7, 352),            # the widest layer: 8 blocks of 44 units
])
def test_gru_seq_kernel(device, B, T, H, reverse):
    gen = torch.Generator(device=device).manual_seed(B + H)

    def arr(*shape, scale):
        return torch.randn(*shape, device=device, generator=gen) * scale
    s = H ** -0.5
    args = (arr(B, T, 3 * H, scale=1.0), arr(3 * H, H, scale=s),
            arr(3 * H, scale=s), arr(B, H, scale=0.5))
    before = K6.launches
    got = K6.gru_seq_layer(*args, reverse=reverse)
    again = K6.gru_seq_layer(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert K6.launches == before + 2
    assert torch.equal(got, again)
    want = K6.plain_gru_seq_layer(*args, reverse=reverse)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # and the CPU emulation of the kernel's arithmetic, on the card's tensors
    torch.testing.assert_close(got, K6.resident_gru_seq_layer(*args, reverse=reverse),
                               rtol=0, atol=1e-4)


def _attention_args(device, B, T, H, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, T, H, 64, device=device, generator=g).to(torch.bfloat16)
            for _ in range(4)]


# (B, T, H): the backbone's shape, long-form's, a ragged last group, small T;
# then the forwards' padding edges: whole 16-row tiles (16, 48, 64), one row
# past a tile (17), fewer heads than a K4 block holds (2, 3); the backbone's
# heads on a rank of a model group of 2 and of 4 (6, 3)
ATTENTION_SHAPES = [(256, 34, 12), (1, 34, 12), (250, 34, 12), (5, 10, 3), (3, 40, 2),
                    (7, 16, 3), (7, 17, 3), (4, 48, 2), (2, 64, 2), (256, 34, 6),
                    (256, 34, 3)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,H", ATTENTION_SHAPES)
def test_fused_attention_kernels(device, B, T, H, rate):
    q, k, v, do = _attention_args(device, B, T, H, seed=B + T)
    args = (0.125, rate, 77)
    before = (K4.launches, K4.bwd_launches)
    got = K4.fused_attention_fwd(q, k, v, *args)
    grads = K4.fused_attention_bwd(q, k, v, do, *args)
    again = K4.fused_attention_bwd(q, k, v, do, *args)
    torch.cuda.synchronize()
    assert (K4.launches, K4.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    _rel_close(got.float(), K4.plain_fused_attention(qf, kf, vf, *args), 1e-2, "out")
    want = K4.plain_fused_attention_bwd(qf, kf, vf, dof, *args)
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        assert a.dtype == torch.bfloat16
        _rel_close(a.float(), c, 1e-2, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,H", ATTENTION_SHAPES)
def test_block_attention_kernels(device, B, T, H, rate):
    q, k, v, do = _attention_args(device, B, T, H, seed=B + T)
    args = (0.125, rate, 77)
    before = (K5.launches, K5.bwd_launches)
    got = K5.block_attention_fwd(q, k, v, *args)
    grads = K5.block_attention_bwd(q, k, v, do, *args)
    again = K5.block_attention_bwd(q, k, v, do, *args)
    torch.cuda.synchronize()
    assert (K5.launches, K5.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    torch.testing.assert_close(got, K5.plain_block_attention(qf, kf, vf, *args),
                               rtol=0, atol=1e-4)
    # K4's plain version: the same function, the same mask
    torch.testing.assert_close(got, K4.plain_fused_attention(qf, kf, vf, *args),
                               rtol=0, atol=1e-4)
    want = K5.plain_block_attention_bwd(qf, kf, vf, dof, *args)
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, again, want):
        assert torch.equal(a, b), f"{name} differs between two calls"
        _rel_close(a, c, name=name)


# (B, T, H) of the backwards: the backbone's at bs 256, a ragged last group
# (250), one window (1); one row (T=1), a whole tile (16), one row past a
# tile (17), one row short of three (33), a strip across three key tiles
# (40), the longest (64)
BWD_SHAPES = [(256, 34, 12), (250, 34, 12), (1, 34, 12), (9, 1, 3), (7, 16, 3),
              (7, 17, 2), (5, 33, 3), (6, 40, 2), (3, 64, 12), (256, 34, 6), (256, 34, 3)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,H", BWD_SHAPES)
def test_attention_backwards(device, B, T, H, rate):
    """K4's and K5's backwards on one set of inputs and one mask: each
    against the plain version and its emulation, bitwise repeat, one launch
    a call, and K5's gradients against K4's."""
    q, k, v, do = _attention_args(device, B, T, H, seed=3 * B + T)
    args = (0.125, rate, 19)
    before = (K4.bwd_launches, K5.bwd_launches)
    g4, again4 = (K4.fused_attention_bwd(q, k, v, do, *args) for _ in range(2))
    g5, again5 = (K5.block_attention_bwd(q, k, v, do, *args) for _ in range(2))
    torch.cuda.synchronize()
    assert (K4.bwd_launches, K5.bwd_launches) == (before[0] + 2, before[1] + 2)
    f32 = [t.float() for t in (q, k, v, do)]
    want = K4.plain_fused_attention_bwd(*f32, *args)
    emu4 = K4.tiled_fused_attention_bwd(*f32, *args)
    emu5 = K5.register_block_attention_bwd(*f32, *args)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert torch.equal(g4[i], again4[i]) and torch.equal(g5[i], again5[i]), name
        assert g4[i].dtype == torch.bfloat16 and g5[i].dtype == torch.float32
        _rel_close(g4[i].float(), want[i], 1e-2, name)
        _rel_close(g5[i], want[i], 1e-4, name)
        _rel_close(g5[i], emu5[i], 1e-5, name)
        gap = (g4[i].float() - emu4[i]).abs()
        slack = 1e-5 * max(1.0, emu4[i].abs().max().item())   # K5's f32 order, then
        assert (gap <= 2 ** -8 * emu4[i].abs() + slack).all(), name   # one rounding
        _rel_close(g5[i], g4[i].float(), 1e-2, name)


@pytest.mark.parametrize("op", ["fused", "block"])
@pytest.mark.parametrize("T", [17, 34])
def test_attention_backward_rows_of_other_samples(device, op, T):
    """Pad rows and other samples contribute nothing: with every sample but
    the first changed (K5: the same group), the first sample's gradients are
    bit for bit the same, and K4's equal those of the sample alone."""
    bwd = K4.fused_attention_bwd if op == "fused" else K5.block_attention_bwd
    q, k, v, do = _attention_args(device, 5, T, 3, seed=T)
    args = (0.125, 0.1, 23)
    base = bwd(q, k, v, do, *args)
    other = [t.clone() for t in (q, k, v, do)]
    for t in other:
        t[1:] = (t[1:].float() * -3.0 + 1.0).to(t.dtype)
    moved = bwd(*other, *args)
    for a, b in zip(base, moved):
        assert torch.equal(a[0], b[0])
        assert not torch.equal(a[1:], b[1:])
    if op == "fused":
        alone = bwd(*(t[:1] for t in (q, k, v, do)), *args)
        for a, b in zip(base, alone):
            assert torch.equal(a[:1], b)


@pytest.mark.parametrize("T", [34, 17])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 8])
def test_block_attention_any_grouping(device, nb, T):
    """Groups of any size give the per-sample result and draw the same mask
    (at T=17 a sample boundary falls inside every other strip)."""
    q, k, v, do = _attention_args(device, 21, T, 2, seed=nb)
    args = (0.125, 0.2, 5)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    torch.testing.assert_close(K5.block_attention_fwd(q, k, v, *args, nb=nb),
                               K4.plain_fused_attention(qf, kf, vf, *args),
                               rtol=0, atol=1e-4)
    want = K4.plain_fused_attention_bwd(qf, kf, vf, dof, *args)
    for name, a, c in zip(("dq", "dk", "dv"),
                          K5.block_attention_bwd(q, k, v, do, *args, nb=nb), want):
        _rel_close(a, c, name=name)


@pytest.mark.parametrize("op", ["fused", "block"])
def test_attention_trains_through_the_kernels(device, op):
    """The autograd Functions on the card, f32 leaves: gradients in the
    leaves' dtype against autograd of the plain forward on the bf16-rounded
    values."""
    fn = K4.fused_attention if op == "fused" else K5.block_attention
    plain = K4.plain_fused_attention
    q, k, v, do = (t.float() for t in _attention_args(device, 9, 34, 4, seed=1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, 0.125, 0.1, 3)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, leaves, do)
    want = torch.autograd.grad(plain(*leaves, 0.125, 0.1, 3), leaves, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _rel_close(a, b, 1e-2 if op == "fused" else 1e-4, name)


def test_wrappers_check_operands(device):
    x = torch.zeros(3, 2, 4, device=device, dtype=torch.float64)
    w = torch.zeros(1, 3, 4, 8, device=device)
    with pytest.raises(ValueError, match="float32"):
        K2.gru_fused_layer(x, w, torch.zeros(1, 3, 1, 8, device=device),
                           torch.zeros(1, 3, 8, 8, device=device),
                           torch.zeros(1, 3, 1, 8, device=device),
                           torch.zeros(2, 8, device=device))
    streams = [torch.zeros(1, 3, 2, 8, device=device, dtype=torch.float16)] * 3
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K3.gru_stack(*streams, torch.zeros(1, 3, 8, 8, device=device),
                     torch.zeros(1, 3, 1, 8, device=device),
                     torch.zeros(2, 8, device=device))
    with pytest.raises(ValueError, match="contiguous float32"):
        K6.gru_seq_layer(torch.zeros(2, 3, 24, device=device),
                         torch.zeros(24, 8, device=device).double(),
                         torch.zeros(24, device=device),
                         torch.zeros(2, 8, device=device))
    q = torch.zeros(2, 34, 4, 32, device=device)
    with pytest.raises(ValueError, match="D == 64"):
        K4.fused_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="D == 64"):
        K5.block_attention(q, q, q, 0.1)
    q = torch.zeros(4, 50, 2, 64, device=device)
    with pytest.raises(ValueError, match="key tiles"):
        K5.block_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="E == 128"):
        K1.reprogramming_attention(torch.zeros(1, 34, 2, 64, device=device),
                                   torch.zeros(2, 5, 64, device=device),
                                   torch.zeros(2, 5, 64, device=device), 0.1)
    # any L: a sample's rows need not fit one tile of the forward
    out = K1.reprogramming_attention(torch.zeros(1, 200, 2, 128, device=device),
                                     torch.zeros(2, 5, 128, device=device),
                                     torch.ones(2, 5, 128, device=device), 0.1)
    assert out.shape == (1, 200, 2, 128)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=0, atol=1e-6)
