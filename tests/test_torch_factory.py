"""The factory's weight-loading facade against the JAX package's.

``load_variables``, ``load_pretrained_variables``, ``get_model_and_variables``
and ``ModelFactory`` of dfc_sa_unet_torch/models/factory.py, at the small
widths of tests/_torch_port.py.  The flagship and ViT-seg are each built once
with seeded port weights, saved as a raw ``.pth`` and as a reference trainer
checkpoint (``model_state_dict``), and named in ``model.pretrained_path``:
JAX's ``get_model_and_variables`` and the port's give eval logits within atol
1e-4, rtol 1e-4 (tests/test_torch_model.py's tolerance) on one numpy-seeded
batch.  The port's own Trainer files load to its weights exactly.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL, VIT_SMALL, images, port_model, to_nchw, to_nhwc, train_config, uint8_batches
from dfc_sa_unet_tpu.models import factory as jax_factory
from dfc_sa_unet_torch.models import factory
from dfc_sa_unet_torch.models.factory import (
    ModelFactory,
    create_model,
    get_model_and_variables,
    load_pretrained_variables,
    load_variables,
    read_variables,
)

torch.set_num_threads(2)
MODELS = {"flagship": SMALL, "vit_seg": VIT_SMALL}
CONVERTER = "scripts/convert_checkpoint.py --config CFG --ckpt DIR --out W.pth --to_torch"


def _config(name, path=None):
    model = dict(MODELS[name])
    if path is not None:
        model["pretrained_path"] = str(path)
    return {"model": model, "dataset": {"img_size": [32, 32]}}


def _equal(a, b):
    assert list(a) == list(b)
    for key in a:
        assert torch.equal(a[key].cpu(), b[key].cpu()), key


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{model: (its seeded state dict, {form: path})}, each model built once."""
    root = tmp_path_factory.mktemp("weights")
    out = {}
    for seed, name in enumerate(MODELS):
        sd = port_model(MODELS[name], seed=10 + seed).state_dict()
        raw, ckpt = root / f"{name}.pth", root / f"{name}_checkpoint.pth"
        torch.save(sd, raw)
        torch.save({"model_state_dict": sd, "epoch": 3}, ckpt)
        out[name] = (sd, {"raw": raw, "trainer_checkpoint": ckpt})
    return out


@pytest.mark.parametrize("form", ["raw", "trainer_checkpoint"])
@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_the_jax_facade(saved, name, form):
    sd, paths = saved[name]
    config = _config(name, paths[form])
    jmodel, variables = jax_factory.get_model_and_variables(config)
    model, loaded = get_model_and_variables(config, device="cpu")
    _equal(loaded, sd)
    x = images(20, (2, 32, 32, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model.eval()(to_nchw(x)))
    assert np.abs(want).max() > 0.1  # not two near-zero maps
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def trainer_files(tmp_path_factory):
    """A port Trainer after one step, and the files its save_checkpoint wrote."""
    from dfc_sa_unet_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("trainer")
    trainer = Trainer(port_model(SMALL, seed=3), None, None, train_config(tmp), device="cpu", progress=False)
    img, mask = uint8_batches(5, 1, 2, (32, 32))[0]
    trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))
    trainer.save_checkpoint(0, is_best=True)
    return trainer.model.state_dict(), tmp / "logs"


@pytest.mark.parametrize("file", ["best_model", "checkpoints/checkpoint_epoch_1", "checkpoints/best_checkpoint"])
def test_the_trainers_own_files_load_exactly(trainer_files, file):
    weights, log_dir = trainer_files
    model = port_model(SMALL, seed=4)
    loaded = load_variables(model, log_dir / file)
    _equal(model.state_dict(), weights)
    _equal(loaded, weights)


def test_the_three_factory_styles_agree(saved):
    sd, paths = saved["flagship"]
    config = _config("flagship", paths["raw"])
    built = []
    for make in (lambda: ModelFactory(config).create_model(device="cpu"),
                 lambda: ModelFactory.get_model(config, device="cpu"),
                 lambda: ModelFactory.get_model_and_variables(config, device="cpu")[0]):
        torch.manual_seed(0)
        built.append(make())
    _equal(built[0].state_dict(), built[1].state_dict())  # the same seeded initialisation
    _equal(built[2].state_dict(), sd)  # the third loaded the file
    _equal(load_pretrained_variables(built[0], config), sd)
    _equal(built[0].state_dict(), built[2].state_dict())
    with pytest.raises(ValueError, match="a config must be provided"):
        ModelFactory().create_model(device="cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_no_pretrained_path_gives_none_and_keeps_the_seeded_weights(name):
    config = _config(name)
    torch.manual_seed(1)
    model, loaded = get_model_and_variables(config, device="cpu")
    assert loaded is None
    assert load_pretrained_variables(model, config) is None
    torch.manual_seed(1)
    _equal(model.state_dict(), create_model(config, device="cpu").state_dict())


@pytest.mark.parametrize("other,names", [
    ({**SMALL, "features": [8, 16, 24, 40]}, r"size mismatch for [\w.]+"),
    (VIT_SMALL, r"Missing key\(s\) in state_dict: .*patch_embed.*Unexpected key\(s\) in state_dict: .*down1"),
], ids=["wrong_width", "wrong_model"])
def test_a_model_that_does_not_fit_raises_naming_the_keys(saved, other, names):
    _, paths = saved["flagship"]
    with pytest.raises(RuntimeError, match=re.compile(names, re.S)):
        get_model_and_variables({"model": {**other, "pretrained_path": str(paths["raw"])}}, device="cpu")


def test_a_directory_raises_with_the_conversion_command(tmp_path):
    model = port_model(SMALL)
    with pytest.raises(IsADirectoryError, match=re.escape(CONVERTER)):
        load_variables(model, tmp_path)
    with pytest.raises(IsADirectoryError, match=re.escape(CONVERTER)):
        read_variables(tmp_path)
    with pytest.raises(IsADirectoryError, match=re.escape(CONVERTER)):
        get_model_and_variables(_config("flagship", tmp_path), device="cpu")


def test_a_path_with_backslashes_loads(saved):
    sd, paths = saved["vit_seg"]
    model, loaded = get_model_and_variables(_config("vit_seg", str(paths["raw"]).replace("/", "\\")), device="cpu")
    _equal(model.state_dict(), sd)


def _cli_config(tmp_path, pretrained):
    from dfc_sa_unet_torch.data.synthetic import generate

    config = train_config(tmp_path)
    data = generate(str(tmp_path / "data"), n=2, size=32, seed=0)
    config["dataset"].update(train_dir=data, val_dir=data)
    config["model"]["pretrained_path"] = str(pretrained)
    return config


def test_build_trainer_warm_starts_through_the_facade(saved, tmp_path, monkeypatch, capsys):
    from dfc_sa_unet_torch.train import cli

    sd, paths = saved["flagship"]
    calls = []
    facade = factory.get_model_and_variables

    def recording(*a, **k):
        calls.append(facade(*a, **k))
        return calls[-1]

    monkeypatch.setattr(factory, "get_model_and_variables", recording)
    trainer = cli.build_trainer(_cli_config(tmp_path, paths["trainer_checkpoint"]),
                                cli.parse_args(["--config", "c.yaml", "--device", "cpu"]))
    assert len(calls) == 1 and calls[0][0] is trainer.model
    _equal(trainer.model.state_dict(), sd)
    assert f"Warm-starting from pretrained weights: {paths['trainer_checkpoint']}" in capsys.readouterr().out


def test_the_training_cli_names_the_converter_for_a_directory(tmp_path):
    import yaml

    from dfc_sa_unet_torch.train import cli

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_cli_config(tmp_path, tmp_path)))
    with pytest.raises(SystemExit, match=re.escape(CONVERTER)):
        cli.main(["--config", str(cfg_path), "--device", "cpu"])
