"""Data-parallel inference in one process (``littlegan_tpu_torch/parallel/infer.py``)
against the JAX package's ``parallel/infer.py`` and the port's one-device calls.

The forwards are row-independent, so splitting a batch's rows over
replicas must not change an output. This sandbox has no card: the
replicas are CPU devices (``["cpu", "cpu"]``, four for the ragged case),
which runs the same wrapper, padding, replication and concatenation; on
the card ``chip_smoke.py`` phase (h) holds two replicas on one H100
against one engine. The JAX wrapper runs over the virtual 8-device mesh.

Tolerances: against JAX rtol 1e-4 / atol 1e-5 (tests/test_torch_models.py);
the port's replicas against its one-device call rtol 1e-5 / atol 1e-6
(only the batch size of each convolution differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.models import generator_apply, init_params as jinit_params
from littlegan_tpu.parallel.infer import data_parallel_infer as jdata_parallel_infer
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.compat.jax_params import params_from_jax
from littlegan_tpu_torch.models.littlegan import LittleGAN, init_params
from littlegan_tpu_torch.parallel import infer as tinfer
from test_torch_train import tcfg_of
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=1e-5, atol=1e-6)
CPUS = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def inputs(tiny_cfg):
    rng = np.random.default_rng(3)
    return (rng.normal(size=(8, tiny_cfg.noise_dim)).astype(np.float32),
            rng.uniform(-1, 1, size=(8, tiny_cfg.cond_dim)).astype(np.float32),
            rng.uniform(-1, 1, size=(8, tiny_cfg.image_dim, tiny_cfg.image_dim, 3)).astype(np.float32))


def _gen(m, z, c):
    return m.generator(z, c)


def test_replicas_match_jax_and_one_device(tiny_cfg, inputs):
    """G, D (a tuple out) and A split over two replicas: equal to the
    one-device calls, and G to the JAX wrapper on the same weights; a
    device output chains into the next call (predict feeds G's images to D)."""
    noise, cond, image = inputs
    jparams = jinit_params(tiny_cfg, jax.random.PRNGKey(0))
    tcfg = tcfg_of(tiny_cfg)
    model = params_from_jax(_flatten(jparams), LittleGAN(tcfg)).eval()
    gen = tinfer.data_parallel_infer(_gen, 2, CPUS)
    got = gen(model, noise, cond)
    jfn = lambda p, n, c: generator_apply(p, n, c, tiny_cfg).astype(jnp.float32)  # noqa: E731
    np.testing.assert_allclose(got.numpy(), np.asarray(jdata_parallel_infer(jfn, 2)(jparams, noise, cond)), **JAX_TOL)
    t = torch.from_numpy
    with torch.inference_mode():
        np.testing.assert_allclose(got.numpy(), model.generator(t(noise), t(cond)).numpy(), **SAME)
        pr, c = tinfer.data_parallel_infer(lambda m, x: m.discriminator(x), 1, CPUS)(model, image)
        want_pr, want_c = model.discriminator(t(image))
        np.testing.assert_allclose(pr.numpy(), want_pr.numpy(), **SAME)
        np.testing.assert_allclose(c.numpy(), want_c.numpy(), **SAME)
        adj = tinfer.data_parallel_infer(lambda m, x, c: m.adjuster(x, c), 2, CPUS)(model, image, cond)
        np.testing.assert_allclose(adj.numpy(), model.adjuster(t(image), t(cond)).numpy(), **SAME)
        pr2, _ = tinfer.data_parallel_infer(lambda m, x: m.discriminator(x), 1, CPUS)(model, got)
        np.testing.assert_allclose(pr2.numpy(), model.discriminator(got)[0].numpy(), **SAME)
    assert gen.devices == [torch.device("cpu")] * 2


def test_ragged_rows(tiny_cfg, inputs):
    """5 rows over 4 replicas: zero-padded to 8, outputs sliced back, equal
    to the one-device call on the 5 rows; ``pad_rows`` on numpy and torch."""
    noise, cond, _ = inputs
    model = init_params(tcfg_of(tiny_cfg), 1).eval()
    out = tinfer.data_parallel_infer(_gen, 2, ["cpu"] * 4)(model, noise[:5], cond[:5])
    with torch.inference_mode():
        want = model.generator(torch.from_numpy(noise[:5]), torch.from_numpy(cond[:5]))
    assert out.shape[0] == 5
    np.testing.assert_allclose(out.numpy(), want.numpy(), **SAME)
    padded = tinfer.pad_rows(noise[:5], 8)
    assert padded.shape == (8, tiny_cfg.noise_dim) and padded.dtype == noise.dtype and (padded[5:] == 0).all()
    assert tinfer.pad_rows(noise, 8) is noise
    tp = tinfer.pad_rows(torch.from_numpy(noise[:5]), 8)
    assert tp.shape == (8, tiny_cfg.noise_dim) and bool((tp[5:] == 0).all())


def test_params_cache_tracks_new_weights(tiny_cfg, inputs):
    """A new weights object is replicated again, an earlier one too when it
    comes back; the same object with a new ``version`` (weights updated in
    place) is replicated again, with the same version it is not."""
    noise, cond, _ = inputs
    dp = tinfer.data_parallel_infer(_gen, 2, CPUS)
    tcfg = tcfg_of(tiny_cfg)
    for seed in (0, 1, 0, 2):
        model = init_params(tcfg, seed).eval()
        with torch.inference_mode():
            want = model.generator(torch.from_numpy(noise), torch.from_numpy(cond))
        np.testing.assert_allclose(dp(model, noise, cond).numpy(), want.numpy(), **SAME, err_msg=str(seed))
    before = dp(model, noise, cond, version=1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    assert torch.equal(dp(model, noise, cond, version=1), before)  # the version says nothing changed
    with torch.inference_mode():
        want = model.generator(torch.from_numpy(noise), torch.from_numpy(cond))
    np.testing.assert_allclose(dp(model, noise, cond, version=2).numpy(), want.numpy(), **SAME)
    with pytest.raises(TypeError, match="expected 2 batch args"):
        dp(model, noise)


def test_infer_mesh_devices(monkeypatch, tmp_path):
    """Every visible card with no process group, 1 under one, 1 on the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tinfer.infer_mesh_devices() == 4
    assert tinfer.infer_mesh_devices("cuda:1") == 4
    assert tinfer.infer_mesh_devices("cpu") == 1
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        assert tinfer.infer_mesh_devices() == 1
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _two_cpus(monkeypatch, module):
    """``module``'s wrappers over two CPU replicas, as over two cards."""
    monkeypatch.setattr(module, "infer_mesh_devices", lambda device=None: 2)
    monkeypatch.setattr(module, "data_parallel_infer",
                        lambda fn, n, devices=None: tinfer.data_parallel_infer(fn, n, CPUS))


def test_featurizer_over_replicas(tiny_cfg, monkeypatch):
    """compute_features: eval_data_parallel over two replicas equals one
    device (random-init Inception, allow_random_fid)."""
    from littlegan_tpu_torch.eval import evaluate

    imgs = np.random.default_rng(5).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    cfg = tcfg_of(tiny_cfg.replace(allow_random_fid=True))
    cfg.extra["device"] = "cpu"
    one = evaluate.compute_features(imgs, cfg.replace(eval_data_parallel=False), batch_size=2)
    _two_cpus(monkeypatch, evaluate)
    two = evaluate.compute_features(imgs, cfg.replace(eval_data_parallel=True), batch_size=2)
    assert "dp" in evaluate._WEIGHTS and two.shape == (2, 2048)
    np.testing.assert_allclose(two, one, rtol=1e-4, atol=1e-4)


def test_engine_over_replicas(tiny_cfg, inputs):
    """InferenceEngine(devices=[cpu, cpu]) against the one-device engine,
    full and ragged requests; a batch the devices do not split is refused."""
    from littlegan_tpu_torch.serving import InferenceEngine

    noise, cond, image = inputs
    cfg = tcfg_of(tiny_cfg.replace(restore=False))
    one = InferenceEngine(cfg, batch_size=8, device="cpu")
    two = InferenceEngine(cfg, batch_size=8, devices=CPUS)
    assert two.n_devices == 2 and one.n_devices == 1
    for rows in (8, 3):
        np.testing.assert_allclose(two.generate(cond[:rows], noise[:rows]), one.generate(cond[:rows], noise[:rows]),
                                   **SAME)
        np.testing.assert_allclose(two.adjust(image[:rows], cond[:rows]), one.adjust(image[:rows], cond[:rows]), **SAME)
        for k, v in two.discriminate(image[:rows]).items():
            np.testing.assert_allclose(v, one.discriminate(image[:rows])[k], **SAME)
    with pytest.raises(ValueError, match="divisible by devices 3"):
        InferenceEngine(cfg, batch_size=8, devices=["cpu"] * 3)


def test_trainer_wiring(tiny_cfg, tmp_path, inputs, monkeypatch):
    """eval_data_parallel with more than one card picks the wrappers
    (``devices``), off it does not; predict / generate / sample_u8 give the
    same outputs either way on the same weights."""
    from littlegan_tpu_torch.training import trainer as ttrainer

    noise, cond, image = inputs
    cfg = tcfg_of(tiny_cfg.replace(all_result_dir=str(tmp_path / "r"), test_data_dir=str(tmp_path / "t"),
                                   exp_name="dp", restore=False, epoch=1))
    one = ttrainer.Trainer(cfg.replace(eval_data_parallel=False), None, device="cpu")
    _two_cpus(monkeypatch, ttrainer)
    two = ttrainer.Trainer(cfg, None, device="cpu")
    assert getattr(two._gen, "devices", None) == [torch.device("cpu")] * 2
    assert getattr(one._gen, "devices", None) is None
    two.state = one.state
    np.testing.assert_allclose(two.generate(noise, cond), one.generate(noise, cond), **SAME)
    np.testing.assert_allclose(two.adjust(image, cond), one.adjust(image, cond), **SAME)
    g2, s2, _, _ = two.predict(noise, cond, image)
    g1, s1, _, _ = one.predict(noise, cond, image)
    np.testing.assert_allclose(g2, g1, **SAME)
    assert s1.keys() == s2.keys()
    u2, u1 = two.sample_u8(noise, cond, image), one.sample_u8(noise, cond, image)
    assert np.abs(u2[0].astype(int) - u1[0]).max() <= 1  # one quantisation level
    assert u2[1]["real_pr"] == u1[1]["real_pr"] and u2[1]["fake_pr"] == u1[1]["fake_pr"]
