"""The port's compiled-artifact cache: ``--exe_cache`` / ``training.exe_cache_dir`` name the directory
the hand-written CUDA kernels are built in and loaded from (``ops/_build.py::set_build_dir``), the
port's counterpart of the JAX package's executable cache (dfc_sa_unet_tpu/utils/exe_cache.py).  The
libraries' names carry a hash of the sources, the flags and ``nvcc --version``.  No card or nvcc here:
the loaded state and the toolkit's version are stood in for."""

import pytest
import torch

from _torch_port import SMALL, port_model, train_config
from dfc_sa_unet_torch import inference as serve_cli
from dfc_sa_unet_torch.infer.predictor import Predictor
from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.train import cli as train_cli
from dfc_sa_unet_torch.train.trainer import Trainer


@pytest.fixture
def build_state(monkeypatch):
    """Every change to the build directory and the loaded state is undone after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_loaded_from", None)
    monkeypatch.setattr(_build, "_nvcc_version", lambda: "Cuda compilation tools, release 12.8, V12.8.93")
    return monkeypatch


def test_the_build_directory_is_set_and_cannot_switch_after_loading(build_state, tmp_path):
    _build.set_build_dir(tmp_path / "a")
    assert _build.BUILD_DIR == (tmp_path / "a").resolve()
    _build.set_build_dir(tmp_path / "b")  # nothing loaded yet: any directory
    assert _build.BUILD_DIR == (tmp_path / "b").resolve()
    build_state.setattr(_build, "_loaded_from", _build.BUILD_DIR)  # as kernel() records a load
    _build.set_build_dir(tmp_path / "b")  # the same directory again is fine
    with pytest.raises(RuntimeError, match="already loaded from"):
        _build.set_build_dir(tmp_path / "a")
    assert _build.BUILD_DIR == (tmp_path / "b").resolve()


def test_the_library_name_follows_the_toolkit(build_state):
    """A new nvcc rebuilds: its ``--version`` text is part of every library's hash."""
    stems = sorted({stem for stem, _ in _build.SIGNATURES.values()})
    before = {stem: _build._digest(stem) for stem in stems}
    assert len(set(before.values())) == len(stems)  # each source its own hash
    build_state.setattr(_build, "_nvcc_version", lambda: "Cuda compilation tools, release 12.9, V12.9.41")
    after = {stem: _build._digest(stem) for stem in stems}
    assert all(after[s] != before[s] for s in stems)


def test_trainer_and_predictor_take_the_setting(build_state, tmp_path):
    Trainer(port_model(SMALL), None, None, train_config(tmp_path, exe_cache_dir=str(tmp_path / "train")),
            device="cpu")
    assert _build.BUILD_DIR == (tmp_path / "train").resolve()
    Predictor(port_model(SMALL), device="cpu", exe_cache_dir=str(tmp_path / "serve"))
    assert _build.BUILD_DIR == (tmp_path / "serve").resolve()


class _Stop(Exception):
    pass


def test_both_clis_take_the_flag(build_state, tmp_path):
    """``--exe_cache`` (and the training CLI's ``--grad_accum_exact``) reach the Trainer's config and
    the build directory; each CLI is stopped where it would start to work."""
    import yaml

    from dfc_sa_unet_torch.data.synthetic import generate

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(train_config(tmp_path)))
    seen = {}

    def fake_build_trainer(config, args, mesh=None):
        seen["training"] = dict(config["training"])
        raise _Stop

    build_state.setattr(train_cli, "build_trainer", fake_build_trainer)
    with pytest.raises(_Stop):
        train_cli.main(["--config", str(cfg_path), "--device", "cpu", "--grad_accum", "2", "--grad_accum_exact",
                        "--exe_cache", str(tmp_path / "train_cache")])
    assert seen["training"]["grad_accum"] == 2 and seen["training"]["grad_accum_exact"] is True
    assert seen["training"]["exe_cache_dir"] == str(tmp_path / "train_cache")

    weights = tmp_path / "w.pth"
    torch.save(port_model(SMALL).state_dict(), weights)
    data = generate(str(tmp_path / "data"), n=1, size=32, seed=0)

    def fake_build_predictor(config, w, bf16=False, engine=False, device=None, exe_cache_dir=None):
        seen["serve"] = (exe_cache_dir, _build.BUILD_DIR)
        raise _Stop

    build_state.setattr(serve_cli, "build_predictor", fake_build_predictor)
    with pytest.raises(_Stop):
        serve_cli.main(serve_cli.parse_args(["--config", str(cfg_path), "--model", str(weights), "--input", data,
                                             "--output", str(tmp_path / "out"), "--device", "cpu",
                                             "--exe_cache", str(tmp_path / "serve_cache")]))
    assert seen["serve"] == (str(tmp_path / "serve_cache"), (tmp_path / "serve_cache").resolve())
