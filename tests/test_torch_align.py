"""ffrnet_torch alignment and ingest vs ffrnet_tpu on the CPU.

Inputs are made with numpy from a seed (or read from the golden fixture)
and handed to both packages. The Pallas warp kernels run in interpret mode,
as tests/test_pallas_kernels.py runs them; on the CPU the port's warp
wrappers take their plain twins.

The warps are tested on SHARED forward matrices: a 1e-6 relative change of
the fixture's matrices moves its crop by about 2e-3 (0-255 scale), and the
two packages solve cp2tform in other precisions (the port in float64, the
JAX package in fp32). Even then the source coordinates differ by an ulp in
places: the port (and its CUDA kernels) rounds every product and sum of
i00*x + i01*y + i02, while XLA's CPU code fuses them into FMAs (about 20%
of the coordinates differ). Where that ulp moves a tap's weight, a pixel of
the fixture's face moves by up to ~4e-3, and of uniform noise by up to
~7e-3. So the warp comparisons use the fixture's decoded face and hold
99% of the values to the stated bound and every value to 1e-2, the bound
the JAX package holds two of its warps to (tests/test_pallas_kernels.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ffrnet_torch.api import REF_PTS_112
from ffrnet_torch.api import FFRNet as TorchFFRNet
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.ops import align as ta
from ffrnet_torch.ops.kernels.warp import (warp_affine_band, warp_affine_band_plain,
                                           warp_affine_full, warp_affine_full_plain)
from ffrnet_torch.tools import align_dataset as t_tool
from ffrnet_tpu.api import FFRNet as JaxFFRNet
from ffrnet_tpu.ops import align as ja
from ffrnet_tpu.ops.pallas.warp import warp_affine_pallas, warp_affine_pallas_band
from ffrnet_tpu.tools import align_dataset as j_tool

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
REF = ja.ARCFACE_REF_PTS
# the tolerance the JAX package holds its cp2tform to against the
# reference's (tests/test_align.py)
MAT_TOL = dict(atol=2e-4, rtol=2e-4)


def assert_warp_close(got, want, atol, atol_max=1e-2, share=1e-2):
    """Every value within `atol_max`, all but a `share` of them within
    `atol` (see the module docstring). Returns the max abs error."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= atol_max, f"max abs error {err.max():.3e} > {atol_max}"
    over = float((err > atol).mean())
    assert over <= share, f"{over:.2%} of values off by more than {atol} (max {err.max():.3e})"
    return err.max()


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(FIXTURE, "expected.npz"))


def _perturbed(n, seed=11):
    """tests/test_pallas_kernels.py's recipe: the reference points at the
    LFW face scale, with 2 px of landmark noise."""
    rng = np.random.default_rng(seed)
    return (REF[None] * 2.1 + rng.normal(0, 2, (n, 5, 2)) + 15).astype(np.float32)


def _rotated(lmk, theta, scale=1.0):
    """Landmarks rotated by `theta` (and scaled) about their mean."""
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    c = lmk.mean(-2, keepdims=True)
    return (((lmk - c) @ rot.T) * scale + c).astype(np.float32)


def _landmark_sets(golden):
    fixture = golden["landmarks"].astype(np.float32)[None]
    mirrored = _perturbed(8, seed=3)
    mirrored[:, :, 0] *= -1.0  # the reflected fit wins
    return {"fixture": fixture, "perturbed": _perturbed(64), "mirrored": mirrored}


def _jax_mats(lmk, ref=REF):
    return np.array(ja.cv2_transform(jnp.asarray(lmk),  # a writable copy for torch
                                     jnp.broadcast_to(jnp.asarray(ref), lmk.shape)))


def _port_mats(lmk, ref=REF):
    ref_t = torch.from_numpy(np.broadcast_to(ref, lmk.shape).copy())
    return ta.cv2_transform(torch.from_numpy(lmk), ref_t).numpy()


@pytest.mark.parametrize("case", ["fixture", "perturbed", "mirrored"])
def test_cv2_transform_matches_jax(golden, case):
    """Measured: 1.6e-4 at most on the perturbed sets (the fp32 JAX solve's
    error), 0.14 of the bound."""
    lmk = _landmark_sets(golden)[case]
    got, want = _port_mats(lmk), _jax_mats(lmk)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **MAT_TOL)
    det = np.linalg.det(got[:, :, :2])
    assert (det < 0).all() if case == "mirrored" else (det > 0).all()


def test_invert_2x3_matches_jax(golden):
    """fp32 on both sides; 2-term sums that XLA may fuse: a few ulp."""
    mats = _jax_mats(_perturbed(64))
    got = ta._invert_2x3(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(ja._invert_2x3(jnp.asarray(mats))),
                               atol=1e-5, rtol=1e-6)


def test_band_guard_matches_jax(golden):
    """The host-side guard is the same float64 numpy on both sides."""
    sets = _landmark_sets(golden)
    sets["x12"] = (REF[None] * 12.0).repeat(2, 0).astype(np.float32)
    sets["x12_rotated"] = _rotated(sets["x12"], 0.5)
    sets["symmetric"] = np.tile(np.array([[0, 0], [10, 0], [5, 5], [0, 10], [10, 10]],
                                         np.float32), (2, 1, 1))
    for name, lmk in sets.items():
        for ref in (REF, REF_PTS_112):
            for a, b in zip(ta._selected_inv_abs_np(lmk, ref),
                            ja._selected_inv_abs_np(lmk, ref)):
                np.testing.assert_array_equal(a, b, err_msg=name)
            for hw, out_h in (((250, 250), 112), ((300, 300), 112), ((120, 90), 56)):
                assert (ta.auto_band_crop_w(lmk, ref, hw, out_h)
                        == ja.auto_band_crop_w(lmk, ref, hw, out_h)), (name, hw)
    # x12 alone still fits a 224-wide band; rotated it needs the full warp
    assert ta.auto_band_crop_w(sets["x12"], REF_PTS_112, (250, 250), 112) == 224
    assert ta.auto_band_crop_w(sets["x12_rotated"], REF_PTS_112, (250, 250), 112) is None


def _shared_case(golden, n=2):
    imgs = np.repeat(golden["decoded"][None].astype(np.float32), n, axis=0)
    return imgs, _jax_mats(_perturbed(n, seed=5))


@pytest.mark.parametrize("out_hw,crop_w", [((112, 112), 64), ((112, 112), 96),
                                           ((112, 96), 64), ((112, 96), 96),
                                           ("violated", 64)])
def test_band_plain_matches_pallas_band(golden, out_hw, crop_w):
    """Measured: max 3.5e-3, 0.03% of values above 1e-3. `violated`:
    landmarks rotated 0.5 rad need a 174-column window; at crop_w 64 both
    kernels read the same truncated window and agree (max 6.4e-3, 0.29%
    above 1e-3), though not with the gather."""
    imgs, mats = _shared_case(golden)
    if out_hw == "violated":
        out_hw = (112, 112)
        lmk = _rotated(_perturbed(2, seed=5), 0.5)
        mats = _jax_mats(lmk)
        assert ta.auto_band_crop_w(lmk, REF, (250, 250), 112) > crop_w
    want = np.asarray(warp_affine_pallas_band(jnp.asarray(imgs), jnp.asarray(mats),
                                              out_hw=out_hw, crop_w=crop_w))
    got = warp_affine_band(torch.from_numpy(imgs), torch.from_numpy(mats), out_hw=out_hw,
                           crop_w=crop_w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *out_hw, 3)
    assert_warp_close(got.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_full_plain_matches_pallas(golden, compute):
    """Measured: max 9.2e-5 (fp32), 1.1e-4 (bf16). bf16 rounds the
    y-weights and the pixels at the same places on both sides."""
    imgs, mats = _shared_case(golden)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute]
    for out_hw in ((112, 112), (112, 96)):
        want = np.asarray(warp_affine_pallas(jnp.asarray(imgs), jnp.asarray(mats),
                                             out_hw=out_hw, compute_dtype=jdt))
        got = warp_affine_full(torch.from_numpy(imgs), torch.from_numpy(mats),
                               out_hw=out_hw, compute_dtype=tdt)
        if compute == "float32":
            assert_warp_close(got.numpy(), want, atol=1e-3)
        else:  # an ulp of a coordinate can flip a bf16 weight: 2^-8 * 255
            assert_warp_close(got.numpy(), want, atol=2e-2, atol_max=1.0)


def test_warp_affine_matches_jax_gather(golden):
    """The port's gather reference vs JAX's (measured: max 3.3e-3, 0.03% of
    values above 1e-3); uint8 input computes in float32, as in JAX."""
    imgs, mats = _shared_case(golden)
    for out_hw in ((112, 112), (112, 96)):
        want = np.asarray(ja.warp_affine(jnp.asarray(imgs), jnp.asarray(mats), out_hw=out_hw))
        got = ta.warp_affine(torch.from_numpy(imgs), torch.from_numpy(mats), out_hw=out_hw)
        assert_warp_close(got.numpy(), want, atol=1e-3)
    u8 = torch.from_numpy(golden["decoded"][None].repeat(2, 0))
    got_u8 = ta.warp_affine(u8, torch.from_numpy(mats), out_hw=(112, 96))
    assert got_u8.dtype == torch.float32
    np.testing.assert_array_equal(
        got_u8.numpy(), ta.warp_affine(u8.float(), torch.from_numpy(mats),
                                       out_hw=(112, 96)).numpy())


@pytest.mark.parametrize("impl", ["auto", "band", "full", "gather"])
def test_align_faces_matches_golden_crop(golden, impl):
    """The fixture's decoded uint8 face -> the pinned `aligned` crop, which
    JAX's gather warp made from fp32 matrices. `band` (at the guard's
    crop_w) and `full` (fp32) are the two warp wrappers on align_faces'
    matrices. Bound: 2e-2, the JAX package's for its non-gather paths
    (tests/test_golden_e2e.py). Measured: 5.2e-4 (auto, band, full) and
    5.3e-4 (gather)."""
    decoded = torch.from_numpy(golden["decoded"][None])
    lmk = golden["landmarks"].astype(np.float32)[None]
    if impl in ta.IMPLS:
        got = ta.align_faces(decoded, lmk, out_hw=(112, 112), impl=impl)
    else:
        mats = torch.from_numpy(_port_mats(lmk))
        if impl == "band":
            got = warp_affine_band(decoded.float(), mats, out_hw=(112, 112),
                                   crop_w=ta.auto_band_crop_w(lmk, REF, (250, 250), 112))
        else:
            got = warp_affine_full(decoded.float(), mats, out_hw=(112, 112),
                                   compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 112, 112, 3)
    np.testing.assert_allclose(got[0].numpy(), golden["aligned"], atol=2e-2, rtol=0)


def test_align_faces_dispatch(golden):
    """The guard picks the band kernel at its smallest exact crop_w, and the
    fp32 full kernel where no crop_w is exact; any other impl raises."""
    imgs = torch.from_numpy(np.repeat(golden["decoded"][None], 2, 0)).float()
    lmk = _perturbed(2, seed=5)
    mats = torch.from_numpy(_port_mats(lmk))
    cw = ta.auto_band_crop_w(lmk, REF, (250, 250), 112)
    assert cw == 96
    np.testing.assert_array_equal(
        ta.align_faces(imgs, lmk).numpy(),
        warp_affine_band_plain(imgs, mats, out_hw=(112, 96), crop_w=cw).numpy())
    extreme = _rotated((REF[None] * 12.0).repeat(2, 0), 0.5)
    mats_x = torch.from_numpy(_port_mats(extreme))
    got = ta.align_faces(imgs, extreme)
    np.testing.assert_array_equal(got.numpy(), warp_affine_full_plain(
        imgs, mats_x, out_hw=(112, 96), compute_dtype=torch.float32).numpy())
    gather = ta.warp_affine(imgs, mats_x, out_hw=(112, 96)).numpy()
    np.testing.assert_allclose(got.numpy(), gather, atol=1e-2)
    for impl in ("band", "full", "tiled", "mxu", "pallas_band"):
        with pytest.raises(ValueError, match="'auto', 'gather'"):
            ta.align_faces(imgs, lmk, impl=impl)


def test_warp_wrappers_reject_what_the_kernels_do_not_take():
    img, mat = torch.rand(1, 40, 40, 3), torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_affine_full(img.to(torch.uint8), mat, out_hw=(8, 8))
    with pytest.raises(ValueError, match="multiple of 32"):
        warp_affine_band(img, mat, out_hw=(8, 8), crop_w=48)
    with pytest.raises(ValueError, match="at most 4 channels"):
        warp_affine_band(torch.rand(1, 40, 40, 5), mat, out_hw=(8, 8))
    with pytest.raises(ValueError, match=r"mats must be \(1, 2, 3\)"):
        warp_affine_full(img, mat[0], out_hw=(8, 8))


@pytest.fixture(scope="module")
def models():
    """The JAX package's FFRNet.random(0) and the port holding its weights."""
    jm = JaxFFRNet.random(seed=0)
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    return jm, TorchFFRNet(enc, rec, RecNetConfig(), "cpu").prepare()


def test_embed_files_matches_jax(models, golden):
    """face_0.jpg through both packages' embed_files (JAX: fp32 cp2tform and
    its column-band XLA warp; the port: float64 cp2tform and the band
    kernel's twin) on shared weights."""
    jm, tm = models
    path = os.path.join(FIXTURE, "face_0.jpg")
    lmk = golden["landmarks"].astype(np.float32)[None]
    want = jm.embed_files([path], lmk)
    got = tm.embed_files([path], lmk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 512)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    raw, rect, crops = tm.embed_canvas(golden["decoded"][None], lmk)
    np.testing.assert_array_equal(raw.numpy(), got[0].numpy())
    assert tuple(crops.shape) == (1, 112, 112, 3)


def test_align_tree_matches_jax_tool(golden, tmp_path):
    """Both tools on one tree of lossless PNGs (so their written crops are
    the crops before any JPEG coding): uint8 crops within 1 step."""
    from PIL import Image

    src = tmp_path / "lfw"
    lines = []
    for k, person in enumerate(("A_Person", "B_Person")):
        (src / person).mkdir(parents=True)
        img = np.roll(golden["decoded"], 3 * k, axis=1)
        Image.fromarray(img).save(src / person / "face_0.png")
        lmk = golden["landmarks"] + np.array([3 * k, 0])
        lines.append(f"{person}/face_0.png\t" + "\t".join(str(v) for v in lmk.ravel()))
    (src / "notes.txt").write_text("not a person directory\n")
    landmarks = tmp_path / "landmarks.txt"
    landmarks.write_text("\n".join(lines) + "\n")
    assert t_tool.read_landmarks(str(landmarks)) == j_tool.read_landmarks(str(landmarks))
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert j_tool.align_tree(str(src), str(landmarks), str(out_j), out_hw=(112, 112)) == 2
    assert t_tool.align_tree(str(src), str(landmarks), str(out_t), out_hw=(112, 112),
                             batch=1, device="cpu") == 2
    for person in ("A_Person", "B_Person"):
        a = np.asarray(Image.open(out_j / person / "face_0.png"), np.int16)
        b = np.asarray(Image.open(out_t / person / "face_0.png"), np.int16)
        assert a.shape == b.shape == (112, 112, 3)
        assert np.abs(a - b).max() <= 1
    t_tool.main(["--src_root", str(src), "--landmarks", str(landmarks),
                 "--save_root", str(tmp_path / "cli"), "--device", "cpu"])
    assert (tmp_path / "cli" / "B_Person" / "face_0.png").is_file()


def test_align_tree_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tool.align_tree(str(tmp_path), str(tmp_path / "none.txt"), str(tmp_path))
