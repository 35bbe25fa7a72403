"""The port's Trainer inference, plot and export against the JAX Trainer's.

Both trainers restore one JAX checkpoint (random weights, an EMA of G's
parts that differs from the live weights) at ``tiny_cfg`` shapes with s2d
and both kernel flags on: the JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions, both in f32 on the CPU.

Tolerances: ``generate``/``adjust`` rtol 1e-4 / atol 1e-5 (as
tests/test_torch_models.py); ``sample_u8``'s uint8 images equal except
where (y + 1) * 127.5 lies within float32 noise of a rounding boundary:
such pixels differ by one level and are counted (at most ``U8_TIES`` per
batch); its score payload's rounded percentages equal but for one point on
``SCORE_TIES`` entries at most, its MSEs rtol 1e-5. ``plot``'s
``models.txt`` byte-equal. Helpers: ``slerp`` exact, ``BatchImageWriter``
byte-equal to ``save_image``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import Checkpointer as JCheckpointer
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu.training.trainer import Trainer as JTrainer
from littlegan_tpu.utils.latent import slerp as jslerp
from littlegan_tpu_torch.training.trainer import Trainer
from littlegan_tpu_torch.utils.image import BatchImageWriter, save_image
from littlegan_tpu_torch.utils.latent import slerp
from test_torch_train import tcfg_of
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-5)
U8_TIES = 4  # pixels of a batch that may differ by one level
SCORE_TIES = 2  # rounded score entries that may differ by one point


@pytest.fixture(scope="module")
def pair(tiny_cfg, tmp_path_factory):
    """(JAX Trainer, port Trainer, cfg) on one restored JAX checkpoint."""
    root = tmp_path_factory.mktemp("sampling")
    jcfg = tiny_cfg.replace(
        all_result_dir=str(root / "result"), test_data_dir=str(root / "td"), exp_name="exp", ema_decay=0.5,
        use_s2d=True, use_pallas=True, use_pallas_boundary=True, train_adj=True, seed=3,
    )
    state = jcreate_train_state(jcfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(0)
    state = state._replace(ema=jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=np.shape(x)).astype(np.float32), state.ema))
    JCheckpointer(os.path.join(jcfg.result_dir, "checkpoint")).save("1", state, {"epoch": 2, "step": 4})
    jt = JTrainer(jcfg, None)
    tt = Trainer(tcfg_of(jcfg), None, device="cpu")
    return jt, tt, jcfg


def _inputs(cfg, n=4, seed=1):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(n, cfg.noise_dim)).astype(np.float32)
    cond = np.where(rng.random((n, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
    image = rng.integers(0, 256, (n, cfg.image_dim, cfg.image_dim, 3)).astype(np.uint8)
    return noise, cond, image


def test_generate_and_adjust_match_jax(pair):
    jt, tt, cfg = pair
    noise, cond, image = _inputs(cfg)
    pm1 = image.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_allclose(tt.generate(noise, cond), jt.generate(noise, cond), **TOL)
    np.testing.assert_allclose(tt.adjust(pm1, cond), jt.adjust(pm1, cond), **TOL)
    # the eval weights are the EMA's: the live generator gives another image
    live = tt.state.model.generator(torch.from_numpy(noise), torch.from_numpy(cond)).detach().numpy()
    assert np.abs(live - tt.generate(noise, cond)).max() > 1e-3


@pytest.mark.parametrize("as_float", [False, True])
def test_sample_u8_matches_jax(pair, as_float):
    """uint8 rows (or the same rows as f32 [-1, 1]) in; the generated and
    both adjusted batches and the D-score payload against JAX's."""
    jt, tt, cfg = pair
    noise, cond, image = _inputs(cfg, seed=2)
    inp = image.astype(np.float32) / 127.5 - 1.0 if as_float else image
    got, want = tt.sample_u8(noise, cond, inp), jt.sample_u8(noise, cond, inp)
    for g, w in zip([got[0], got[2], got[3]], [want[0], want[2], want[3]]):
        assert g.dtype == np.uint8 and g.shape == w.shape == image.shape
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and int((diff > 0).sum()) <= U8_TIES, (diff.max(), int((diff > 0).sum()))
    gs, ws = got[1], want[1]
    assert list(gs) == list(ws)
    for k, v in ws.items():
        if isinstance(v, list):
            d = np.abs(np.asarray(gs[k]) - np.asarray(v))
            assert d.max() <= 1 and int((d > 0).sum()) <= SCORE_TIES, k
        else:
            np.testing.assert_allclose(gs[k], v, rtol=1e-5, err_msg=k)
    json.dumps(gs)  # the payload evaluate-sample writes


def test_eval_model_is_built_once_and_tracks_the_ema(tiny_cfg, tmp_path):
    """With an EMA the eval model is one object over the state's storage:
    after the step's in-place EMA update ``generate`` gives what a model
    loaded from ``eval_params`` then gives, exactly."""
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.training.state import eval_params
    from littlegan_tpu_torch.training.step import _update_ema

    cfg = tcfg_of(tiny_cfg.replace(all_result_dir=str(tmp_path), test_data_dir=str(tmp_path / "td"), ema_decay=0.5))
    tt = Trainer(cfg, None, device="cpu")
    noise, cond, _ = _inputs(cfg)
    before = tt.generate(noise, cond)
    model = tt.eval_model()
    with torch.no_grad():
        for p in tt.state.model.parameters():
            p.add_(0.1)
    _update_ema(tt.state, cfg)
    assert tt.eval_model() is model
    fresh = LittleGAN(cfg)
    fresh.load_state_dict(eval_params(tt.state))
    with torch.inference_mode():
        want = fresh.generator(torch.from_numpy(noise), torch.from_numpy(cond)).float().numpy()
    got = tt.generate(noise, cond)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - before).max() > 1e-3


def test_sample_u8_without_adjuster(tiny_cfg, tmp_path):
    cfg = tcfg_of(tiny_cfg.replace(all_result_dir=str(tmp_path), test_data_dir=str(tmp_path / "td"), train_adj=False))
    noise, cond, image = _inputs(cfg)
    gen, scores, adj_real, adj_fake = Trainer(cfg, None, device="cpu").sample_u8(noise, cond, image)
    assert gen.dtype == np.uint8 and gen.shape == image.shape and adj_real is None and adj_fake is None
    assert len(scores["fake_pr"]) == 4


def test_plot_models_txt_byte_equal_to_jax(pair):
    """``models.txt`` and each network's ``.dot`` graph, byte for byte (both
    trainers write into the same result directory, one after the other)."""
    jt, tt, cfg = pair
    nets = ("Encoder", "Decoder", "Discriminator", "Generator", "Adjuster")
    read = lambda name: open(os.path.join(cfg.result_dir, name)).read()  # noqa: E731
    want = jt.plot()
    want_dots = {n: read(f"{n}.dot") for n in nets}
    os.remove(os.path.join(cfg.result_dir, "models.txt"))
    assert tt.plot() == want == read("models.txt")
    assert {n: read(f"{n}.dot") for n in nets} == want_dots
    assert "->" in want_dots["Adjuster"]


def test_exported_model_loads_into_jax(pair):
    """The weights-only npz restores into a JAX parameter template and its
    generator gives the port's ``generate`` output (the eval weights)."""
    from littlegan_tpu.models import generator_apply, init_params

    jt, tt, cfg = pair
    path = tt.export_model_checkpoint()
    assert path == os.path.join(cfg.result_dir, "model", "ckpt-model.npz")
    template = init_params(cfg, jax.random.PRNGKey(0))
    restored = JCheckpointer(os.path.dirname(path)).restore("model", template)
    assert sorted(_flatten(restored)) == sorted(_flatten(template))
    noise, cond, _ = _inputs(cfg, seed=4)
    np.testing.assert_allclose(np.asarray(generator_apply(restored, noise, cond, cfg)), tt.generate(noise, cond), **TOL)


def test_slerp_equals_jax():
    rng = np.random.default_rng(0)
    z0, z1 = rng.normal(size=(3, 13)), rng.normal(size=(3, 13))
    z1[1] = 2 * z0[1]  # parallel pair: the lerp fallback
    t = np.linspace(0, 1, 5, dtype=np.float32)
    np.testing.assert_array_equal(slerp(z0, z1, t), jslerp(z0, z1, t))


def test_batch_image_writer_writes_save_image_bytes(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    with BatchImageWriter(workers=3, max_pending=2) as w:
        for i, img in enumerate(imgs):
            w.save(img, str(tmp_path / f"w{i}.jpg"))
    for i, img in enumerate(imgs):
        save_image(img, str(tmp_path / f"s{i}.jpg"))
        assert (tmp_path / f"w{i}.jpg").read_bytes() == (tmp_path / f"s{i}.jpg").read_bytes()
    w = BatchImageWriter(workers=1)
    w.save(imgs[0], str(tmp_path / "missing" / "x.jpg"))  # a worker's error surfaces on close
    with pytest.raises(FileNotFoundError):
        w.close()


def test_pinned_checkpoints_survive_pruning_and_callback_runs(tiny_cfg, tmp_path):
    from littlegan_tpu_torch.data import SyntheticDataset

    cfg = tcfg_of(tiny_cfg.replace(all_result_dir=str(tmp_path), test_data_dir=str(tmp_path / "td"), epoch=4,
                                   keep_checkpoints=1, freq_gen=0, freq_test=0))
    trainer = Trainer(cfg, SyntheticDataset(cfg, num_items=8), device="cpu")
    trainer.pin_checkpoint(1)
    trainer.pin_checkpoint(2)
    seen = []

    def callback(epoch):
        seen.append((epoch, trainer.checkpointer.epoch_tags()))
        if epoch == 2:
            trainer.unpin_checkpoint(2)

    trainer.train(epoch_callback=callback)
    assert seen == [(1, [1]), (2, [1, 2]), (3, [1, 3]), (4, [1, 4])]
