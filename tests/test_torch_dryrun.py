"""The port's dry run (``littlegan_tpu_torch/dryrun.py``) against the JAX
repo's ``__graft_entry__.py``, on the CPU.

- ``dryrun_multichip`` with ``device="cpu"`` over 2 and 4 gloo rank
  processes prints JAX's nine regime tags in JAX's order (read from
  ``__graft_entry__.py``'s source), each OK: JAX's dry run passes every
  regime at an even device count. At 1 rank (one card's host) the spatial
  regimes print JAX's ``skipped: odd device count`` and the rest are OK;
  there JAX's ZeRO-1 assertion fails (one device shards nothing) and the
  port runs ZeRO-1's collectives on two ranks' axes instead. With the
  kernel flags on the regimes run too (the CPU takes the plain versions).
- Without a card and without ``--device cpu`` it raises
  (``utils/device.py::resolve_device``), as ``entry()`` does; ``entry("cpu")``
  gives JAX's flagship forward: 128x128, batch 8, bf16.
"""

import ast
import os
import re

import pytest
import torch

from littlegan_tpu_torch import dryrun
from littlegan_tpu_torch.config import Config
from torch_dp_common import REPO
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)


def _jax_lines(n: int):
    """(tag, "OK" or "skipped") per regime as JAX's ``_dryrun_regimes``
    prints them at ``n`` devices, from its source: a ``check("tag", ...)``
    is an OK line, and a spatial regime's ``else`` branch prints
    ``[tag] skipped: odd device count`` at an odd ``n``."""
    with open(os.path.join(REPO, "__graft_entry__.py")) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "_dryrun_regimes")
    out = []

    def walk(stmts):
        for st in stmts:
            if isinstance(st, ast.If) and "n_devices % 2" in ast.unparse(st.test):
                walk(st.body if n % 2 == 0 else st.orelse)
            elif isinstance(st, ast.Try):
                walk(st.body)
            else:
                src = ast.unparse(st)
                for tag in re.findall(r"\bcheck\('(\w+)'", src):
                    out.append((tag, "OK"))
                for tag, word in re.findall(r"\[(\w+)\] (OK|skipped)", src):
                    out.append((tag, word))

    walk(fn.body)
    return out


@pytest.mark.parametrize("n,kernels", [(2, False), (4, False), (1, True)])
def test_dryrun_prints_jax_regimes_in_order(n, kernels, capsys):
    want = _jax_lines(n)
    assert len(want) == 9
    dryrun.dryrun_multichip(n, device="cpu", kernels=kernels)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(f"dryrun_multichip({n}) ")]
    got = [re.match(rf"dryrun_multichip\({n}\) \[(\w+)\] (OK|skipped)", ln).groups() for ln in lines]
    skipped = [t for t, w in want if w == "skipped"]
    assert skipped == ([] if n % 2 == 0 else ["spatial", "shard_dense", "accum_x_spatial", "shard_dense_x_zero1"])
    assert got == want
    for ln in lines:
        if "] OK: {" in ln:
            assert re.search(r"'loss/gen': -?\d", ln) and "nan" not in ln
    assert lines[-1] == f"dryrun_multichip({n}) [infer_dp] OK: {n + 1} ragged rows over {n} devices"


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    from littlegan_tpu_torch.utils import device

    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device(d or "cuda", 0) if d != "cpu"
                        else torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"2 ranks exceed the 1 visible CUDA devices"):
        dryrun.main(["2"])


def test_dryrun_and_entry_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    fn, (noise, cond) = dryrun.entry("cpu")
    cfg = Config(compute_dtype="bfloat16")
    assert tuple(noise.shape) == (8, cfg.noise_dim) and tuple(cond.shape) == (8, cfg.cond_dim)
    out = fn(noise, cond)
    assert tuple(out.shape) == (8, cfg.image_dim, cfg.image_dim, 3) == (8, 128, 128, 3)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
