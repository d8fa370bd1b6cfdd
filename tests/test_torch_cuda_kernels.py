"""The port's hand-written kernels against their plain versions, on the
card (`cuda` marker: skips where no GPU is present).

Run on a machine with an NVIDIA Hopper GPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: posenc, one bf16 ulp at the largest |value| (< 4): 2^-6; the
field, 2e-2 absolute plus 2e-2 relative on outputs of O(1) — both sides
use bf16 operands and float32 sums, in different orders, so an activation
may round to a neighbouring bf16 value and carry that through the blocks.
"""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops.field import FieldWeights, field_plain, pyramid_field_fused
from pixelnerf_tpu_torch.utils.hocon import loads
from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_concat_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_posenc_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    base = torch.randn((5000, 3), generator=g).to(cuda)
    vd = torch.randn((5000, 3), generator=g).to(cuda)
    before = posenc_concat.launches
    got = posenc_concat(base, vd, 6, 1.5)
    torch.cuda.synchronize()
    assert posenc_concat.launches == before + 1
    want = posenc_concat_plain(base, vd, 6, 1.5)
    assert got.shape == want.shape == (5000, 42) and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -6


@pytest.mark.parametrize(
    "ns,sb,b", [(1, 2, 50), (2, 1, 64), (2, 2, 37), (3, 1, 45), (5, 2, 13), (20, 1, 7)]
)
def test_field_kernel_matches_plain(cuda, ns, sb, b):
    rng = np.random.default_rng(ns * 100 + b)
    shapes = [(16, 16, 32), (8, 8, 32), (4, 4, 64)]
    d_in, hidden, n_blocks, combine = 42, 64, 5, 3
    d_latent = sum(c for (_, _, c) in shapes)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)

    feats = [t(rng.normal(size=(sb * ns, h, w, c)), torch.bfloat16) for (h, w, c) in shapes]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    xin = t(rng.normal(size=(sb, ns, b, d_in)), torch.bfloat16)

    def m(*shape):
        return t(rng.normal(size=shape, scale=1.0 / np.sqrt(shape[-2] if len(shape) > 1 else 10)))

    w = FieldWeights(
        w_in=m(d_in, hidden), b_in=m(hidden), wz=m(3, d_latent, hidden), bz=m(3, hidden),
        w0=m(n_blocks, hidden, hidden), b0=m(n_blocks, hidden),
        w1=m(n_blocks, hidden, hidden), b1=m(n_blocks, hidden),
        w_out=m(hidden, 4), b_out=m(4),
    )
    before = pyramid_field_fused.launches
    got = pyramid_field_fused(feats, grid, xin, w, n_blocks, combine, ns)
    torch.cuda.synchronize()
    assert pyramid_field_fused.launches == before + 1
    want = field_plain(feats, grid, xin, w, n_blocks, combine, ns)
    assert got.shape == want.shape == (sb, b, 4)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_field_kernel_raises_past_its_shared_memory(cuda):
    """At the flagship width a tile of 33 views does not fit in shared
    memory: the wrapper raises instead of launching."""
    ns, d_in, hidden, d_latent = 33, 42, 512, 512
    z = lambda *shape: torch.zeros(shape, device=cuda)
    w = FieldWeights(
        w_in=z(d_in, hidden), b_in=z(hidden), wz=z(3, d_latent, hidden), bz=z(3, hidden),
        w0=z(5, hidden, hidden), b0=z(5, hidden), w1=z(5, hidden, hidden), b1=z(5, hidden),
        w_out=z(hidden, 4), b_out=z(4),
    )
    feats = [z(ns, 8, 8, d_latent).to(torch.bfloat16)]
    before = pyramid_field_fused.launches
    with pytest.raises(ValueError, match="shared memory"):
        pyramid_field_fused(feats, z(1, ns, 4, 2), z(1, ns, 4, d_in).to(torch.bfloat16), w, 5, 3, ns)
    assert pyramid_field_fused.launches == before


QUERY_CONF = """
model {
    dtype = bfloat16
    use_xyz = True
    use_code = True
    code {
        num_freqs = 6
        freq_factor = 1.5
        include_input = True
    }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse {
        type = resnet
        n_blocks = 5
        d_hidden = 64
        combine_layer = 3
    }
    mlp_fine {
        type = resnet
        n_blocks = 5
        d_hidden = 64
        combine_layer = 3
    }
    encoder {
        backbone = resnet34
        num_layers = 4
    }
}
"""


def test_query_three_views_launches_the_field_kernel(cuda):
    """Three source views go through the fused field kernel on the card
    (not the per-layer path), and agree with the CPU plain versions of the
    same model at the slice's bf16 tolerance (5e-2 on sigmoid/relu
    outputs, see test_torch_slice.py)."""
    import copy

    from pixelnerf_tpu_torch.models.pixelnerf import make_model

    rng = np.random.default_rng(3)
    model = make_model(loads(QUERY_CONF)["model"], device=cuda, seed=0)
    with torch.no_grad():
        for mlp in (model.mlp_coarse, model.mlp_fine):
            for i in range(mlp.n_blocks):
                fc1 = getattr(mlp, f"block_{i}").fc_1.weight
                fc1.copy_(torch.randn(fc1.shape) * 0.1)
            # outputs of O(1), off the sigmoid's flat ends: the random
            # trunk's latents are O(10), so scale the output layer down and
            # take out the part common to all hidden units
            w_out = mlp.lin_out.weight
            w_out.mul_(0.1).sub_(w_out.mean(dim=1, keepdim=True))
    images = torch.from_numpy(rng.uniform(-1, 1, size=(1, 3, 32, 32, 3)).astype(np.float32))
    poses = torch.eye(4).repeat(1, 3, 1, 1)
    poses[0, :, 2, 3] = torch.tensor([1.3, 1.4, 1.5])
    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, size=(1, 50, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(1, 50, 3)).astype(np.float32)), dim=-1)

    fused = model.with_field_fusion()
    model_cpu = copy.deepcopy(model).to("cpu").with_field_fusion()
    with torch.no_grad():
        enc = fused.encode(images, poses, 35.0)
        assert enc.num_views == 3 and isinstance(enc.latent, tuple)
        before = pyramid_field_fused.launches
        got = fused.query(enc, xyz.to(cuda), vd.to(cuda), coarse=False)
        torch.cuda.synchronize()
        assert pyramid_field_fused.launches == before + 1
        want = model_cpu.query(enc.to("cpu"), xyz, vd, coarse=False)
    assert got.shape == want.shape == (1, 50, 4)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-2)
