"""The port's public surface held to the JAX package's.

Every module of dfc_sa_unet_tpu/ is parsed with ``ast`` (not imported) for its
public names: top-level functions and classes, the public methods of public
classes, upper-case module constants, and the names a package's ``__init__.py``
lists in ``__all__``.  Each must do one of three things:

(a) resolve by import in dfc_sa_unet_torch at the same module path and name;
(b) stand in ``COUNTERPARTS`` with the port's name for it, which must import;
(c) stand in ``NOT_PORTED`` with a reason that cites a section of ROADMAP.md,
    which must name it.

One case per JAX name, and one per table entry: an entry whose JAX name is gone,
or which (a) already satisfies, is stale and fails.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "dfc_sa_unet_tpu"
ROADMAP = (ROOT / "ROADMAP.md").read_text(encoding="utf-8")
NOT_PORTED_SECTION = 'ROADMAP "Not to be ported"'
DIFFERENCES_SECTION = 'ROADMAP "Differences that are not faults"'

# JAX name -> "module:attribute" of the port's counterpart under another name or path
COUNTERPARTS = {
    "data/__init__.py:normalize_on_device": "dfc_sa_unet_torch.data:normalize",
    "data/loader.py:normalize_on_device": "dfc_sa_unet_torch.data.normalize:normalize",
    "data/loader.py:binarize_mask_on_device": "dfc_sa_unet_torch.data.loader:binarize_mask",
    "nn/layers.py:bn_cross_replica_axis": "dfc_sa_unet_torch.nn.layers:bn_cross_replica",
    "ops/pallas_attention.py:fused_pooled_attention": "dfc_sa_unet_torch.ops.pooled_attention:pooled_attention",
    "ops/pallas_attention.py:fused_mha": "dfc_sa_unet_torch.ops.mha:fused_mha",
    "ops/pallas_attention.py:fused_mha_sep": "dfc_sa_unet_torch.ops.mha:fused_mha_sep",
    "ops/pallas_conv.py:conv3x3_bn_relu": "dfc_sa_unet_torch.ops.dfc_tail:conv3x3_bn_relu",
    "ops/pallas_conv.py:dfc_tail_from_x": "dfc_sa_unet_torch.ops.dfc_tail:dfc_tail",
    "parallel/multihost.py:initialize": "dfc_sa_unet_torch.parallel.mesh:data_parallel_mesh",
    "parallel/spmd.py:make_spmd_train_step": "dfc_sa_unet_torch.train.trainer:Trainer.train_step",
    "train/optim.py:sgd_with_clip": "dfc_sa_unet_torch.train.optim:SGDWithClip",
    "utils/checkpoint.py:save_pytree": "dfc_sa_unet_torch.utils.checkpoint:save_tree",
    "utils/checkpoint.py:restore_pytree": "dfc_sa_unet_torch.utils.checkpoint:restore_tree",
    "utils/exe_cache.py:cached_compile": "dfc_sa_unet_torch.ops._build:set_build_dir",
    "utils/exe_cache.py:source_fingerprint": "dfc_sa_unet_torch.ops._build:_digest",
    "utils/torch_convert.py:variables_to_torch_state_dict": "dfc_sa_unet_torch.utils.weights:from_jax_variables",
    "utils/torch_convert.py:load_torch_checkpoint": "dfc_sa_unet_torch.utils.weights:load_state_dict_file",
}

_FLAX_INIT = f"{NOT_PORTED_SECTION}: torch's modules initialise themselves as the reference does"
_MATRIX = f"{NOT_PORTED_SECTION}: the TPU's matmul formulation; the port calls torch's op"
_GSPMD = f"{NOT_PORTED_SECTION}: a GSPMD helper; the port's collectives are explicit (parallel/rows.py, spmd.py)"
_CONVERT = f"{NOT_PORTED_SECTION}: utils/torch_convert.py; a port module holds torch weights already"
_TRAIN_STATE = f"{NOT_PORTED_SECTION}: Flax's functional train state; the port's Trainer holds module and optimiser"
NOT_PORTED = {
    "infer/quant.py:calibration_forward": f"{DIFFERENCES_SECTION}: the port calibrates on the engine's device",
    "nn/__init__.py:conv_kernel_init": _FLAX_INIT,
    "nn/__init__.py:torch_bias_init": _FLAX_INIT,
    "nn/layers.py:conv_kernel_init": _FLAX_INIT,
    "nn/layers.py:torch_bias_init": _FLAX_INIT,
    "ops/__init__.py:adaptive_pool_matrix": _MATRIX,
    "ops/__init__.py:bilinear_matrix": _MATRIX,
    "ops/pooling.py:adaptive_pool_matrix": _MATRIX,
    "ops/resize.py:bilinear_matrix": _MATRIX,
    "ops/pallas_conv.py:conv_supported": f"{DIFFERENCES_SECTION}: the port's kernel masks any H and W",
    "parallel/__init__.py:replicate": _GSPMD,
    "parallel/__init__.py:shard_batch": _GSPMD,
    "parallel/mesh.py:replicate": _GSPMD,
    "parallel/mesh.py:shard_batch": _GSPMD,
    "parallel/multihost.py:global_batch": _GSPMD,
    "parallel/multihost.py:host_local": _GSPMD,
    "parallel/spmd.py:AXIS": _GSPMD,
    "parallel/multihost.py:local_device_count": f"{DIFFERENCES_SECTION}: one process per card under torchrun",
    "train/__init__.py:TrainState": _TRAIN_STATE,
    "train/trainer.py:TrainState": _TRAIN_STATE,
    "train/trainer.py:Trainer.init_state": _TRAIN_STATE,
    "utils/exe_cache.py:tree_fingerprint": f"{DIFFERENCES_SECTION}: nothing weight-dependent is compiled",
    "utils/torch_convert.py:torch_state_dict_to_variables": _CONVERT,
    "utils/torch_convert.py:save_torch_checkpoint": _CONVERT,
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _module_names(path: pathlib.Path):
    """The public names that ``path`` defines (and, for an ``__init__.py``, lists in ``__all__``)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            yield node.name
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            yield node.name
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(item.name):
                    yield f"{node.name}.{item.name}"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name) and target.id == "__all__" and path.name == "__init__.py":
                    yield from ast.literal_eval(node.value)
                elif isinstance(target, ast.Name) and target.id.isupper() and _public(target.id):
                    yield target.id


def jax_names():
    """["models/factory.py:ModelFactory.get_model", ...] for the whole JAX package, in file order."""
    keys = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        keys.extend(f"{rel}:{name}" for name in dict.fromkeys(_module_names(path)))
    return keys


JAX_NAMES = jax_names()


def _port_module(rel: str) -> str:
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["dfc_sa_unet_torch", *parts])


def _resolve(module: str, attr: str):
    """The object at ``module`` + dotted ``attr``, or raise ImportError / AttributeError."""
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _same_path(key: str):
    rel, name = key.split(":")
    return _resolve(_port_module(rel), name)


def _resolves_at_same_path(key: str) -> bool:
    try:
        _same_path(key)
    except (ImportError, AttributeError):
        return False
    return True


def test_the_jax_package_is_read_whole():
    """The parse sees the whole package: its factory, its kernels' wrappers, its exports."""
    assert len(JAX_NAMES) > 150
    for key in ("models/factory.py:ModelFactory.get_model_and_variables", "models/__init__.py:UNet",
                "ops/pallas_attention.py:fused_pooled_attention", "ops/attention.py:full_res_self_attention",
                "utils/profiling.py:trace", "parallel/spmd.py:AXIS", "ops/__init__.py:bilinear_matrix"):
        assert key in JAX_NAMES, key


@pytest.mark.parametrize("key", JAX_NAMES)
def test_jax_name_has_a_counterpart(key):
    if key in COUNTERPARTS:
        _resolve(*COUNTERPARTS[key].split(":"))
    elif key in NOT_PORTED:
        assert NOT_PORTED[key].startswith((NOT_PORTED_SECTION, DIFFERENCES_SECTION)), NOT_PORTED[key]
    else:
        assert _same_path(key) is not None


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_counterpart_entry_is_current(key):
    """The JAX name exists, the port has no name of its own at the same path, and the target imports."""
    assert key in JAX_NAMES, f"{key} is no longer a public name of the JAX package"
    assert key not in NOT_PORTED
    assert not _resolves_at_same_path(key), f"{key} resolves at the same path: the entry is stale"
    module, attr = COUNTERPARTS[key].split(":")
    assert module.startswith("dfc_sa_unet_torch")
    _resolve(module, attr)


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entry_is_current(key):
    """The JAX name exists, the port still lacks it, and the ROADMAP section cited names it."""
    assert key in JAX_NAMES, f"{key} is no longer a public name of the JAX package"
    assert not _resolves_at_same_path(key), f"{key} resolves at the same path: the entry is stale"
    reason = NOT_PORTED[key]
    section = reason.split(":")[0]
    assert section in (NOT_PORTED_SECTION, DIFFERENCES_SECTION), reason
    assert section.split('"')[1] in ROADMAP, f"ROADMAP.md has no section {section}"
    assert f"`{key.split(':')[1]}`" in ROADMAP, f"ROADMAP.md does not name {key}"
