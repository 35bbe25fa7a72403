"""The port's eval/ against the JAX package's, on the CPU in f32.

- Inception features, both pooling variants (torchvision; FIDInception,
  marked by ``meta/fid2015_pool``), at 128² (the 299 resize runs) and 299²,
  on the converter's synthetic state dict: against JAX ``inception_features``
  rtol 1e-4 / atol 1e-4 (the same float32 network, sums in another order),
  and against the straight-line torch transcription
  (tests/torch_inception_ref.py) and the committed golden features rtol
  1e-3 / atol 1e-3, the tolerance tests/test_fid.py holds JAX to.
- The 299 resize: ``F.interpolate`` (half-pixel bilinear, no antialias)
  against ``jax.image.resize(..., antialias=False)``, up and down, atol 1e-4
  on [0, 255] pixels.
- The random init: the same arrays as JAX's, exactly.
- Host metrics on the same features: class probabilities, IS, KID, PRDC and
  scipy FID exactly (float64 numpy copies); Newton–Schulz FID against JAX's
  rtol 1e-4 and against scipy 5e-3 (tests/test_fid.py's bound).
- Evaluation: ``precalculate`` -> ``evaluate_generated`` on 8 JPEGs with
  IS, KID and PRDC writes the log lines JAX's evaluate.py writes, the values
  rtol 1e-3 (FID from 8 samples of 2048-d features runs through a
  singular covariance's eps fallback, which amplifies feature rounding).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.eval import evaluate as jev
from littlegan_tpu.eval import fid as jfid
from littlegan_tpu.eval import inception as jinc
from littlegan_tpu.eval.inception_score import inception_score as jinception_score
from littlegan_tpu.eval.kid import kid as jkid
from littlegan_tpu.eval.prdc import prdc as jprdc
from littlegan_tpu_torch.eval import evaluate as tev
from littlegan_tpu_torch.eval import fid as tfid
from littlegan_tpu_torch.eval import inception as tinc
from littlegan_tpu_torch.eval.inception_score import inception_score
from littlegan_tpu_torch.eval.kid import kid
from littlegan_tpu_torch.eval.prdc import prdc
from test_torch_train import tcfg_of
from tests.torch_inception_ref import Mutation, torch_inception_features

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=1e-3, atol=1e-3)


def _converter():
    spec = importlib.util.spec_from_file_location("convert_inception", REPO / "scripts" / "convert_inception.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted():
    """variant -> (raw state dict, converted npz params)."""
    conv = _converter()
    out = {}
    for variant, seed in (("tv", 6), ("fid2015", 12)):
        sd = conv.synthetic_state_dict(seed=seed, **({"variant": "fid2015"} if variant == "fid2015" else {}))
        out[variant] = (sd, conv.convert(sd))
    return out


def test_random_init_equals_jax():
    want = jinc.init_inception_params("", seed=0)
    got = tinc.init_inception_params("", seed=0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tinc._conv_specs() == jinc._conv_specs()


@pytest.mark.parametrize("dim", [128, 299])
@pytest.mark.parametrize("variant", ["tv", "fid2015"])
def test_inception_features_match_jax_and_torch_reference(converted, variant, dim):
    sd, params = converted[variant]
    assert tinc.inception_variant(params) == jinc.inception_variant(params) == variant
    img = np.random.default_rng(dim).integers(0, 256, (2, dim, dim, 3)).astype(np.float32)
    got = tinc.inception_features(params, torch.from_numpy(img)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    want = np.asarray(jax.jit(jinc.inception_features)(params, jnp.asarray(img)))
    np.testing.assert_allclose(got, want, **JAX_TOL)
    ref = torch_inception_features(sd, img, Mutation(fid_pool=variant == "fid2015")).numpy()
    np.testing.assert_allclose(got, ref, **REF_TOL)


@pytest.mark.parametrize("variant,name", [("tv", "inception_synthetic_goldens.npz"),
                                          ("fid2015", "inception_synthetic_goldens_fid2015.npz")])
def test_inception_features_match_golden_fixtures(converted, variant, name):
    with np.load(REPO / "tests" / "golden" / name) as z:
        imgs, want = z["images"], z["features"]
    got = tinc.inception_features(converted[variant][1], torch.from_numpy(imgs.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, **REF_TOL)


def test_variants_differ(converted):
    """The marker switches the pooling: the FIDInception weights through the
    torchvision pooling give other features."""
    _, params = converted["fid2015"]
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 299, 299, 3)).astype(np.float32))
    tv = {k: v for k, v in params.items() if k != tinc.FID2015_MARKER}
    assert (tinc.inception_features(params, img) - tinc.inception_features(tv, img)).abs().max() > 1e-2


@pytest.mark.parametrize("src", [128, 512])
def test_resize_matches_jax_image_resize(src):
    x = np.random.default_rng(src).integers(0, 256, (2, src, src, 3)).astype(np.float32)
    got = tinc.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear", antialias=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_device_params_are_oihw(converted):
    _, params = converted["tv"]
    dev = tinc.device_params(params, "cpu")
    w = params["mix6b/b7_2/w"]  # (1, 7, cin, cout) HWIO
    assert tuple(dev["mix6b/b7_2/w"].shape) == (w.shape[3], w.shape[2], 1, 7)
    np.testing.assert_array_equal(dev["mix6b/b7_2/w"].numpy(), np.transpose(w, (3, 2, 0, 1)))


# --------------------------------------------------------- host metrics ----


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(3)
    real = rng.normal(size=(40, 2048)).astype(np.float32)
    gen = (rng.normal(size=(36, 2048)) * 1.1 + 0.05).astype(np.float32)
    return real, gen


def test_class_probs_and_inception_score_equal_jax(converted, features):
    _, params = converted["tv"]
    probs = tinc.class_probs_from_features(params, features[1])
    np.testing.assert_array_equal(probs, jinc.class_probs_from_features(params, features[1]))
    assert inception_score(probs, splits=4) == jinception_score(probs, splits=4)
    with pytest.raises(KeyError, match="fc/w"):
        tinc.class_probs_from_features({}, features[1])


def test_kid_and_prdc_equal_jax(features):
    real, gen = features
    assert kid(real, gen, subset_size=20, n_subsets=5) == jkid(real, gen, subset_size=20, n_subsets=5)
    assert kid(real[:10], gen[:10]) == jkid(real[:10], gen[:10])
    assert prdc(real, gen, k=3) == jprdc(real, gen, k=3)


def test_fid_scipy_and_newton_schulz_match_jax():
    """scipy FID equal to JAX's (the same float64 numpy); the Newton–Schulz
    FID on the CPU against JAX's and against scipy, on a well-conditioned
    pair (more samples than dimensions), as tests/test_fid.py does."""
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(256, 64)), rng.normal(size=(256, 64)) * 1.2 + 0.1
    mu1, s1 = tfid.activation_statistics(a)
    mu2, s2 = tfid.activation_statistics(b)
    jmu1, js1 = jfid.activation_statistics(a)
    np.testing.assert_array_equal(mu1, jmu1)
    np.testing.assert_array_equal(s1, js1)
    host = tfid.frechet_distance(mu1, s1, mu2, s2)
    assert host == jfid.frechet_distance(mu1, s1, mu2, s2)
    ns = tfid.frechet_distance_newton_schulz(mu1, s1, mu2, s2, device="cpu")
    np.testing.assert_allclose(ns, jfid.frechet_distance_newton_schulz(mu1, s1, mu2, s2), rtol=1e-4)
    assert abs(ns - host) / abs(host) < 5e-3
    with pytest.raises(ValueError, match="mismatched"):
        tfid.frechet_distance(mu1, s1, mu2[:3], s2[:3, :3])


def test_newton_schulz_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfid.frechet_distance_newton_schulz(np.zeros(2), np.eye(2), np.zeros(2), np.eye(2))


# ----------------------------------------------------------- evaluate.py ----


def _jpegs(d, n, seed, dim=16):
    from PIL import Image

    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (dim, dim, 3), dtype=np.uint8)).save(d / f"{i}.jpg")
    return d


def _numbers(text):
    """(label skeleton, numbers) of each log line, without its time stamp."""
    out = []
    for line in text.strip().splitlines():
        body = line.split(" ", 2)[2]
        out.append((re.sub(r"-?\d[\d.e+-]*", "#", body), [float(x) for x in re.findall(r"-?\d[\d.e+-]*", body)]))
    return out


def test_precalculate_and_evaluate_write_jax_log_values(tiny_cfg, tmp_path):
    real, gen = _jpegs(tmp_path / "real", 8, 0), _jpegs(tmp_path / "gen", 8, 1)
    jcfg = tiny_cfg.replace(allow_random_fid=True)
    tcfg = tcfg_of(jcfg)
    tcfg.extra["device"] = "cpu"
    logs = {}
    for name, ev, cfg in (("jax", jev, jcfg), ("torch", tev, tcfg)):
        stats, log = tmp_path / f"{name}.npz", tmp_path / f"{name}.log"
        ev.precalculate(cfg, str(real), str(stats), batch_size=8, save_features=8)
        fid = ev.evaluate_generated(cfg, str(gen), str(stats), str(log), batch_size=8, with_is=True,
                                    with_kid=True, with_prdc=True)
        assert np.isfinite(fid)
        logs[name] = _numbers(log.read_text())
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "torch.npz") as t:
        assert sorted(j.files) == sorted(t.files) == ["features", "mu", "sigma"]
        np.testing.assert_allclose(t["mu"], j["mu"], rtol=1e-4, atol=1e-5)
    assert [s for s, _ in logs["torch"]] == [s for s, _ in logs["jax"]]
    assert all("RANDOM-INIT" in s for s, _ in logs["torch"])
    for (_, got), (skel, want) in zip(logs["torch"], logs["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-9, err_msg=skel)


def test_evaluation_refuses_random_fid_without_opt_in(tiny_cfg, tmp_path):
    d = _jpegs(tmp_path / "imgs", 1, 0)
    cfg = tcfg_of(tiny_cfg.replace(allow_random_fid=False))
    cfg.extra["device"] = "cpu"
    with pytest.raises(RuntimeError, match="allow_random_fid"):
        tev.precalculate(cfg, str(d), str(tmp_path / "s.npz"), batch_size=4)
    with pytest.raises(RuntimeError, match="allow_random_fid"):
        tev.compute_features(np.zeros((1, 16, 16, 3), np.uint8), cfg)


def test_compute_features_in_chunks_equals_files_and_one_call(tiny_cfg, tmp_path):
    """``compute_features`` over an array, 3 images a call, gives the
    features ``compute_features_from_files`` gives for the same pixels as
    PNGs and those of one ``inception_features`` call, rtol 1e-5 / atol 1e-5
    (the batch changes the convolutions' summation order)."""
    from PIL import Image

    imgs = np.random.default_rng(9).integers(0, 256, (7, 16, 16, 3), dtype=np.uint8)
    files = []
    for i, img in enumerate(imgs):
        files.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(files[-1])
    cfg = tcfg_of(tiny_cfg.replace(allow_random_fid=True))
    cfg.extra["device"] = "cpu"
    got = tev.compute_features(imgs, cfg, batch_size=3)
    assert got.shape == (7, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, tev.compute_features_from_files(files, cfg, batch_size=3), rtol=1e-5, atol=1e-5)
    params = tinc.device_params(tinc.init_inception_params("", seed=0), "cpu")
    np.testing.assert_allclose(got, tinc.inception_features(params, torch.from_numpy(imgs)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_evaluation_kid_needs_saved_features(tiny_cfg, tmp_path):
    d = _jpegs(tmp_path / "imgs", 4, 0)
    cfg = tcfg_of(tiny_cfg.replace(allow_random_fid=True))
    cfg.extra["device"] = "cpu"
    tev.precalculate(cfg, str(d), str(tmp_path / "s.npz"), batch_size=4)
    for kw, what in ((dict(with_kid=True), "KID needs"), (dict(with_prdc=True), "precision/recall need")):
        with pytest.raises(ValueError, match=what):
            tev.evaluate_generated(cfg, str(d), str(tmp_path / "s.npz"), str(tmp_path / "l.log"), **kw)


def test_precalculate_from_zip_matches_directory(tiny_cfg, tmp_path):
    import zipfile

    d = _jpegs(tmp_path / "imgs", 6, 4)
    zpath = tmp_path / "imgs.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for i in range(6):
            z.write(d / f"{i}.jpg", f"imgs/{i}.jpg")
    cfg = tcfg_of(tiny_cfg.replace(allow_random_fid=True))
    cfg.extra["device"] = "cpu"
    tev.precalculate(cfg, str(d), str(tmp_path / "dir.npz"), batch_size=4)
    tev.precalculate(cfg, str(zpath), str(tmp_path / "zip.npz"), batch_size=4)
    with np.load(tmp_path / "dir.npz") as a, np.load(tmp_path / "zip.npz") as b:
        np.testing.assert_array_equal(a["sigma"], b["sigma"])


def test_load_images_center_crops_like_jax(tmp_path):
    from PIL import Image

    arr = np.zeros((32, 16, 3), np.uint8)
    arr[16:] = 255
    Image.fromarray(arr).save(tmp_path / "tall.png")
    Image.fromarray(np.full((20, 20, 3), 7, np.uint8)).save(tmp_path / "sq.png")
    for paths, dim in (([str(tmp_path / "tall.png")], 16), ([str(tmp_path / "sq.png")], 12)):
        np.testing.assert_array_equal(tev._load_images(paths, dim), jev._load_images(paths, dim))
    with pytest.raises(ValueError, match="mixed image sizes"):
        tev._load_images([str(tmp_path / "tall.png"), str(tmp_path / "sq.png")])


def test_metric_labels_equal_jax(tiny_cfg, tmp_path):
    conv = _converter()
    for variant in ("tv", "fid2015"):
        path = tmp_path / f"{variant}.npz"
        sd = conv.synthetic_state_dict(seed=20, **({"variant": variant} if variant == "fid2015" else {}))
        np.savez(path, **conv.convert(sd))
        for w in ("", str(path)):
            jcfg = tiny_cfg.replace(fid_weights=w)
            assert tev.fid_label(tcfg_of(jcfg)) == jev.fid_label(jcfg)
            assert tev.is_label(tcfg_of(jcfg)) == jev.is_label(jcfg)


def test_eval_cli_two_modes(tmp_path, monkeypatch):
    """``python -m littlegan_tpu_torch.eval.evaluate``: pre-calculate writes
    the stats npz, any other mode is calc and appends to the log."""
    d = _jpegs(tmp_path / "imgs", 4, 0)
    (tmp_path / "sample.config.json").write_text(
        '{"batch_size": 4, "image_dim": 16, "init_dim": 1, "noise_dim": 13, "attr": [0, 1, 2, 3, 4, 5, 6], '
        '"conv_filter": [24, 16, 12, 8, 4], "allow_random_fid": true, "debug": true}'
    )
    monkeypatch.chdir(tmp_path)
    stats, log = tmp_path / "s.npz", tmp_path / "fid.log"
    assert tev.main(["pre-calculate", str(d), str(stats), "--device", "cpu", "--save-features", "4"]) == 0
    assert tev.main(["calculate", str(d), str(stats), "", str(log), "--device", "cpu", "--kid", "--is"]) == 0
    text = log.read_text()
    assert "FID[RANDOM-INIT" in text and "KID[RANDOM-INIT" in text and "IS[RANDOM-INIT" in text
