"""rnet_torch augmentation vs rnet's on the CPU.

* ``rnet_torch.kernels.augment``: the plain version of the fused kernel
  against rnet's ``gather_augment_reference`` and against rnet's Pallas
  kernel run in interpret mode, on the same seeded inputs — offsets 0 and
  16 on both axes (where the rolls wrap around the canvas), angles 0 and
  ±MAX_DEG, B = 6 and repeated indices; the shear radii; the draws; the
  CPU dispatch of ``augment_impl="pallas"`` (the plain version, no launch);
  the CUDA kernel's two-tap shear, written in torch ops, bit for bit equal
  to the 2K+1-tap ``_shear`` the plain version uses.
* ``rnet_torch.data.augment`` (the model-side ``xla`` path): rotation, crop
  and centre crop against rnet's with the same explicit angles and offsets.

The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.data import augment as jaug
from rnet.kernels import augment as jker
from rnet_torch.config import load_config
from rnet_torch.data import augment as taug
from rnet_torch.kernels import augment as tker
from rnet_torch.train import steps as tsteps

torch.set_num_threads(1)

# Tolerance of the plain version vs rnet's reference and the interpret-mode
# kernel: the same fp32 arithmetic in the same order; 1e-5 is
# test_fused_augment_kernel_interpret_matches_oracle's bound.
ATOL = 1e-5


def _inputs(B=6, N=10, S=144, out=128, seed=0):
    rs = np.random.RandomState(seed)
    cache = rs.randint(0, 256, (N, S, S, 3), dtype=np.uint8)
    idx = rs.randint(0, N, (B,)).astype(np.int32)
    idx[1] = idx[0]  # a repeated index
    m = S - out
    offs = rs.randint(0, m + 1, (B, 2)).astype(np.int32)
    offs[:4] = [[0, 0], [m, m], [0, m], [m, 0]]  # wrap-around corners
    deg = rs.uniform(-jker.MAX_DEG, jker.MAX_DEG, B)
    deg[:3] = [jker.MAX_DEG, -jker.MAX_DEG, 0.0]
    angles = np.deg2rad(deg).astype(np.float32)
    return cache, idx, angles, offs


def _port(cache, idx, angles, offs, out=128, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (cache, idx, angles, offs)]
    return tker.gather_augment_reference(*t, out, dtype)


def test_plain_version_matches_rnet_reference_and_interpret_kernel():
    cache, idx, angles, offs = _inputs()
    j = [jnp.asarray(a) for a in (cache, idx, angles, offs)]
    want = np.asarray(jker.gather_augment_reference(*j, 128, jnp.float32))
    kern = np.asarray(jker._fused_pallas(*j, 128, jnp.float32, True))
    got = _port(cache, idx, angles, offs).numpy()
    assert got.shape == (6, 128, 128, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, kern, atol=ATOL)


@pytest.mark.parametrize("angle_sign", [1.0, -1.0])
def test_corner_crops_read_wrapped_pixels(angle_sign):
    """The shears roll mod S: a crop at row offset 0 reads the canvas's last
    rows (and at column offset 0 its last columns). A canvas that is white
    only in its last 4 rows and columns gives a nonzero crop at (0, 0); a
    clamping or zero-filling version would give 0 there."""
    cache = np.zeros((1, 144, 144, 3), np.uint8)
    cache[0, -4:] = 255
    cache[0, :, -4:] = 255
    angles = np.array([angle_sign * np.deg2rad(jker.MAX_DEG)], np.float32)
    offs = np.zeros((1, 2), np.int32)
    got = _port(cache, np.zeros(1, np.int32), angles, offs).numpy()[0]
    want = np.asarray(jker.gather_augment_reference(jnp.asarray(cache), jnp.zeros(1, jnp.int32),
                                                    jnp.asarray(angles), jnp.asarray(offs), 128, jnp.float32))[0]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[:2].max() > 0.05 or got[:, :2].max() > 0.05


@pytest.mark.parametrize("S, out, B", [(48, 32, 8), (20, 12, 5)])
def test_plain_version_matches_rnet_at_other_sizes(S, out, B):
    cache, idx, angles, offs = _inputs(B=B, N=5, S=S, out=out, seed=S)
    j = [jnp.asarray(a) for a in (cache, idx, angles, offs)]
    want = np.asarray(jker.gather_augment_reference(*j, out, jnp.float32))
    np.testing.assert_allclose(_port(cache, idx, angles, offs, out).numpy(), want, atol=ATOL)
    want16 = np.asarray(jker.gather_augment_reference(*j, out, jnp.bfloat16).astype(jnp.float32))
    got16 = _port(cache, idx, angles, offs, out, torch.bfloat16).float().numpy()
    # one rounding of nearly equal fp32 values: at most one bf16 step (2^-8 below 1)
    np.testing.assert_allclose(got16, want16, atol=2.0**-8)


def test_zero_angle_is_the_normalized_crop():
    cache, idx, _, offs = _inputs()
    got = _port(cache, idx, np.zeros(6, np.float32), offs).numpy()
    src = cache[idx].astype(np.float32) * np.float32(1 / 255)
    for k in range(6):
        np.testing.assert_array_equal(got[k], src[k, offs[k, 0] : offs[k, 0] + 128, offs[k, 1] : offs[k, 1] + 128])


@pytest.mark.parametrize("S, out", [(144, 128), (48, 32), (200, 128), (64, 64)])
def test_shear_radii_match_rnet(S, out):
    assert tker._shear_radii(S, out) == jker._shear_radii(S, out)
    assert tker.MAX_DEG == jker.MAX_DEG


def test_draws_are_in_range_and_reproducible():
    cache = torch.zeros((4, 144, 144, 3), dtype=torch.uint8)
    a1, o1 = tker.draw_augment_params(4096, 144, 128, torch.Generator().manual_seed(3), "cpu")
    a2, o2 = tker.draw_augment_params(4096, 144, 128, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a1, a2) and torch.equal(o1, o2)
    assert a1.dtype == torch.float32 and o1.dtype == torch.int32 and tuple(o1.shape) == (4096, 2)
    bound = tker.MAX_DEG * math.pi / 180
    assert a1.abs().max().item() <= bound and a1.abs().max().item() > 0.9 * bound
    assert o1.min().item() == 0 and o1.max().item() == 16  # both ends of [0, margin] drawn
    out = tker.gather_augment(cache, torch.zeros(5, dtype=torch.int32), torch.Generator().manual_seed(1), 128)
    assert out.shape == (5, 128, 128, 3) and out.dtype == torch.bfloat16


def _two_tap_shear(images, shifts, axis, k_max):
    """The CUDA kernel's shear (csrc/augment.cu) in torch ops and its order:
    per line only the taps k0 = floor(shift) clamped to [-K, K-1] and k0 + 1,
    each weighted hat(shift - k), tap k0 first."""
    k0 = torch.floor(shifts).clamp(-k_max, k_max - 1)
    w0 = torch.clamp(1.0 - (shifts - k0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (shifts - (k0 + 1)).abs(), min=0.0)
    n = images.shape[axis]
    if axis == 2:  # per row: out[b, r, c] = img[b, r, (c - k) mod n]
        shape, lead = (images.shape[0], shifts.shape[1], 1, 1), lambda t: t[:, :, None]
    else:  # per column: out[b, r, c] = img[b, (r - k) mod n, c]
        shape, lead = (images.shape[0], 1, shifts.shape[1], 1), lambda t: t[:, None, :]
    pos = torch.arange(n).reshape([-1 if d == axis else 1 for d in range(3)])

    def tap(k):
        src = (pos - lead(k.long())) % n
        return torch.gather(images, axis, src[..., None].expand(images.shape))

    return w0.reshape(shape) * tap(k0) + w1.reshape(shape) * tap(k0 + 1)


@pytest.mark.parametrize("axis, k_max", [(2, 2), (1, 4), (2, 1)])
def test_two_tap_shear_is_bitwise_the_full_shear(axis, k_max):
    """The kernel's two-tap shear equals ``_shear``'s 2K+1-tap sum bit for
    bit on non-negative images: every other tap has weight exactly 0 and
    adds +0. Shifts: random in [-K, K], integers, exactly +-K, past K on
    both sides (the clamped pair keeps the one tap that can be non-zero),
    beyond K+1 (all taps 0), +-0.0 and values just off an integer."""
    rs = np.random.RandomState(10 * axis + k_max)
    B, n = 3, 40
    images = torch.from_numpy(rs.randint(0, 256, (B, n, n, 3)).astype(np.float32)) * (1.0 / 255.0)
    special = [0.0, -0.0, 1.0, -1.0, float(k_max), -float(k_max), k_max + 0.25, -k_max - 0.25,
               k_max + 0.999, -k_max - 0.999, k_max + 1.5, -k_max - 3.0, 1e-7, -1e-7, 1 - 1e-7,
               k_max - 1e-6, -k_max + 1e-6, 0.5, -0.5]
    shifts = rs.uniform(-k_max, k_max, (B, n)).astype(np.float32)
    shifts[0, : len(special)] = special
    shifts[1] = np.round(shifts[1])  # integer shifts
    s = torch.from_numpy(shifts)
    assert torch.signbit(s[0, 1]) and s[0, 1] == 0  # -0.0 kept
    want = taug._shear(images, s, axis=axis, k_max=k_max)
    got = _two_tap_shear(images, s, axis, k_max)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    # and the canvas-size case the kernel runs: (2, 4) radii on 144^2
    kx, ky = tker._shear_radii(144, 128)
    big = torch.from_numpy(rs.randint(0, 256, (2, 144, 144, 3)).astype(np.float32)) * (1.0 / 255.0)
    t = torch.from_numpy(rs.uniform(-ky, ky, (2, 144)).astype(np.float32))
    k = kx if axis == 2 else ky
    t = t.clamp(-k - 0.5, k + 0.5)
    assert torch.equal(_two_tap_shear(big, t, axis, k), taug._shear(big, t, axis=axis, k_max=k))


def test_kernel_wrapper_refuses_what_it_does_not_take():
    cache, idx, angles, offs = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="CUDA"):
        tker.augment_cuda(cache, idx, angles, offs, 128)
    with pytest.raises(ValueError, match="int32"):
        tker.augment_cuda(cache, idx.long(), angles, offs, 128)
    with pytest.raises(ValueError, match="out_size"):
        tker.augment_cuda(cache, idx, angles, offs, 200)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tker.augment_cuda(cache, idx, angles, offs, 128, torch.float16)
    with pytest.raises(ValueError, match="16 bytes"):  # 140 * 3 = 420 B rows
        tker.augment_cuda(cache[:, :140, :140].contiguous(), idx, angles, offs, 128)
    with pytest.raises(ValueError, match=r"\(N, S, S, 3\)"):
        tker.augment_cuda(cache[..., :1].contiguous(), idx, angles, offs, 128)


def test_crop_batch_clamps_as_dynamic_slice():
    """Offsets past the far edge of the canvas start the crop at S - out, as
    ``jax.lax.dynamic_slice`` (rnet's crop) clamps its start."""
    imgs = np.arange(2 * 12 * 12, dtype=np.float32).reshape(2, 12, 12, 1)
    offs = np.array([[9, 2]], np.int32)
    want = np.stack([np.asarray(jax.lax.dynamic_slice(jnp.asarray(im), (9, 2, 0), (8, 8, 1))) for im in imgs])
    np.testing.assert_array_equal(taug.crop_batch(torch.from_numpy(imgs), torch.from_numpy(offs), 8).numpy(), want)


def test_pallas_impl_on_cpu_takes_the_plain_version():
    """augment_impl="pallas" on the CPU: the fused branch of _train_inputs
    runs with the plain version and launches nothing; ``auto`` on the CPU
    leaves the augmentation to the model."""
    cfg = load_config("original-fp", overrides={"compute_dtype": "float32"}).replace(
        image_size=32, device_augment=True, augment_impl="pallas"
    )
    rs = np.random.RandomState(2)
    cache = torch.from_numpy(rs.randint(0, 256, (5, 48, 48, 3), dtype=np.uint8))
    b = {"image_idx": torch.tensor([4, 0, 4, 2], dtype=torch.int32)}
    tker.reset_launches()
    cpu = torch.device("cpu")
    got, augmented = tsteps._train_inputs(b, cfg, cache, torch.Generator().manual_seed(5), cpu)
    assert augmented and tker.launches["augment"] == 0
    angles, offs = tker.draw_augment_params(4, 48, 32, torch.Generator().manual_seed(5), cpu)
    want = tker.gather_augment_reference(cache, b["image_idx"], angles, offs, 32, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # batch-local source: padded canvases in the batch itself
    pb = {"image": cache[[1, 3]]}
    got, augmented = tsteps._train_inputs(pb, cfg, None, torch.Generator().manual_seed(5), cpu)
    assert augmented and got.shape == (2, 32, 32, 3)
    inputs, augmented = tsteps._train_inputs(b, cfg.replace(augment_impl="auto"), cache, None, cpu)
    assert not augmented and inputs.shape == (4, 48, 48, 3)
    assert not tsteps._fused_augment_ok(cfg.replace(augment_impl="xla"), torch.device("cuda"))
    assert tsteps._fused_augment_ok(cfg.replace(augment_impl="auto"), torch.device("cuda"))
    assert not tsteps._fused_augment_ok(cfg.replace(state_description=True), torch.device("cuda"))


# ---------------------------------------------------------------------------
# rnet_torch.data.augment (the model-side xla path)
# ---------------------------------------------------------------------------


def _smooth(B=3, S=64):
    y, x = np.mgrid[0:S, 0:S]
    base = np.exp(-((x - 40) ** 2 + (y - 24) ** 2) / 120.0) + x / 128.0 + y / 180.0
    return np.stack([np.stack([base * (1 + 0.1 * c) for c in range(3)], -1)] * B).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_shear_batch_matches_rnet(dtype):
    """The same angles through both packages (rnet draws them from a key in
    random_rotate_batch; the port takes them as arguments). fp32: the same
    arithmetic, 1e-5. bf16: every op rounds in bf16 in both packages, at
    other points; held to test_rotate_shear_bf16_tracks_oracle's mean 0.02."""
    imgs = _smooth()
    key = jax.random.key(4)
    jd = jnp.dtype(dtype)
    want = np.asarray(jaug.random_rotate_batch(jnp.asarray(imgs, jd), key).astype(jnp.float32))
    angles = np.array(jax.random.uniform(key, (3,), minval=-2.8, maxval=2.8) * (jnp.pi / 180.0))
    td = getattr(torch, dtype)
    got = taug.rotate_shear_batch(torch.from_numpy(imgs).to(td), torch.from_numpy(angles).to(td)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        assert float(np.abs(got - want).mean()) < 0.02


def test_rotation_tracks_bilinear_oracle_and_matches_rnets():
    imgs = _smooth()
    for a in (0.0, 0.045, -0.04):
        got = taug.rotate_bilinear(torch.from_numpy(imgs[0]), a).numpy()
        want = np.asarray(jaug.rotate_bilinear(jnp.asarray(imgs[0]), jnp.float32(a)))
        np.testing.assert_allclose(got, want, atol=ATOL)
    out = taug.rotate_shear_batch(torch.from_numpy(imgs), torch.tensor([0.0, 0.045, -0.04])).numpy()
    np.testing.assert_allclose(out[0], imgs[0], atol=1e-6)  # angle 0: identity
    ref = taug.rotate_bilinear(torch.from_numpy(imgs[1]), 0.045).numpy()
    assert float(np.abs(out[1, 6:-6, 6:-6] - ref[6:-6, 6:-6]).mean()) < 2e-3


@pytest.mark.parametrize("B, groups", [(8, 4), (16, 32), (6, 32)])
def test_crop_batch_matches_rnet(B, groups):
    """rnet's per-group offsets (drawn from its key) through the port's crop."""
    imgs = np.arange(B * 12 * 12, dtype=np.float32).reshape(B, 12, 12, 1)
    key = jax.random.key(B)
    want = np.asarray(jaug.random_crop_batch(jnp.asarray(imgs), key, 8, groups=groups))
    G = taug.crop_groups(B, groups)
    offs = np.array(jax.random.randint(key, (G, 2), 0, 5))
    got = taug.crop_batch(torch.from_numpy(imgs), torch.from_numpy(offs), 8).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = taug.draw_crop_offsets(B, 12, 8, torch.Generator().manual_seed(0), "cpu", groups)
    assert tuple(drawn.shape) == (G, 2) and 0 <= drawn.min() and drawn.max() <= 4


def test_center_crop_matches_rnet():
    imgs = np.random.RandomState(3).randint(0, 256, (2, 45, 45, 3)).astype(np.uint8)
    want = np.asarray(jaug.center_crop_batch(jnp.asarray(imgs), 32))
    np.testing.assert_array_equal(taug.center_crop_batch(torch.from_numpy(imgs), 32).numpy(), want)
