"""Model statistics: parameters, size, FLOPs, activation memory (counterpart of the root
model_stats.py, with its flags and ``--device``).

    python -m dfc_sa_unet_torch.model_stats --config CFG.yaml [--output DIR]
        [--batch_size N] [--height H] [--width W] [--channels C] [--device cuda|cpu]

Prints and writes (``DIR/<model>_stats.txt``, ``.csv``, ``_layers.csv``, ``_params_pie.png``):

* parameters per top-level module and per leaf module (a module holding parameters itself),
  named by the port's state-dict keys, which are the reference checkpoints';
* the forward summary: every module called in one forward, its output shape (NCHW) and its
  parameters, taken by forward hooks;
* analytic FLOPs per leaf with the JAX tool's formula (model_stats.py:116-168): a conv or a
  linear layer 2 x output positions x kernel size, a transposed conv that divided by its stride
  squared; parameter-free work (attention products, norms, resizes) counts 0 there;
* the measured total, in FLOPs and in MACs (one MAC = 2 FLOPs), by
  ``torch.utils.flop_counter.FlopCounterMode`` over one forward of a CPU copy of the model.  The
  counter sees aten operations only, and on the card the port's kernels (pooled attention, MHA,
  the DFC tail, conv3x3) launch through ctypes where it cannot see them; on the CPU every kernel
  wrapper runs its plain PyTorch version, whose products the counter does see.  So the total is
  always counted where the wrappers run their plain versions;
* peak activation memory: on the card, ``torch.cuda.max_memory_allocated`` during one forward
  under ``inference_mode`` above what the weights and the input hold (XLA's temp buffers in the
  JAX tool); on the CPU it is not measured.

Weights are torch's default initialisation: the statistics do not depend on their values.
"""

import argparse
import copy
import csv
import os

import torch
from torch import nn

from dfc_sa_unet_torch.config import load_config
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.device import resolve_device


def count_parameters(model: nn.Module):
    """(rows of (top-level module, parameters), total): the reference's per-module breakdown."""
    rows = [(name, sum(p.numel() for p in child.parameters())) for name, child in model.named_children()]
    rows = [r for r in rows if r[1]]
    return rows, sum(p.numel() for p in model.parameters())


def leaf_parameter_rows(model: nn.Module):
    """[(module path, parameters it holds itself)] for every module that holds some."""
    rows = []
    for name, mod in model.named_modules():
        n = sum(p.numel() for p in mod.parameters(recurse=False))
        if n:
            rows.append((name or "<root>", n))
    return rows


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        return next((t for t in out if isinstance(t, torch.Tensor)), None)
    return None


def output_shapes(model: nn.Module, x: torch.Tensor):
    """{module path: output shape of its first call} over one eval forward of ``x``, in call order."""
    shapes = {}
    hooks = []
    for name, mod in model.named_modules():
        def hook(_m, _inp, out, name=name or "<root>"):
            t = _first_tensor(out)
            if t is not None and name not in shapes:
                shapes[name] = tuple(t.shape)
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def forward_summary(model: nn.Module, x: torch.Tensor):
    """[(module path, output shape, parameters under it)] for every module called, in call order."""
    mods = dict(model.named_modules())
    return [(name, shape, sum(p.numel() for p in mods["" if name == "<root>" else name].parameters()))
            for name, shape in output_shapes(model, x).items()]


def _leaf_flops(mod: nn.Module, shape) -> int:
    """The JAX tool's per-leaf formula: 2 x output positions x kernel size, / stride^2 for a
    transposed conv (every input position applies the whole kernel)."""
    if shape is None:
        return 0
    numel = 1
    for d in shape:
        numel *= d
    flops = 0
    if isinstance(mod, nn.ConvTranspose2d):
        flops += 2 * (numel // shape[1]) * mod.weight.numel() // (mod.stride[0] * mod.stride[1])
    elif isinstance(mod, nn.Conv2d):
        flops += 2 * (numel // shape[1]) * mod.weight.numel()
    elif isinstance(mod, nn.Linear):
        flops += 2 * (numel // shape[-1]) * mod.weight.numel()
    for pname, p in mod.named_parameters(recurse=False):
        if pname.endswith("proj_weight"):  # a packed attention projection
            flops += 2 * (numel // shape[-1]) * p.numel()
    return flops


def leaf_flops_rows(model: nn.Module, x: torch.Tensor):
    """[(leaf module path, analytic FLOPs)] in :func:`leaf_parameter_rows`' order."""
    shapes = output_shapes(model, x)
    mods = dict(model.named_modules())
    return [(name, _leaf_flops(mods["" if name == "<root>" else name], shapes.get(name)))
            for name, _ in leaf_parameter_rows(model)]


def module_flops_rows(model: nn.Module, leaf_rows):
    """Leaf FLOPs summed into the top-level modules."""
    agg = {name: 0 for name, _ in model.named_children()}
    for path, fl in leaf_rows:
        top = path.split(".", 1)[0]
        if top in agg:
            agg[top] += fl
    return agg


def model_flops(model: nn.Module, x: torch.Tensor) -> int:
    """FLOPs of one forward, counted by FlopCounterMode on a CPU copy of ``model`` (where every kernel
    wrapper runs its plain version, which the counter sees)."""
    from torch.utils.flop_counter import FlopCounterMode

    cpu_model = model if next(model.parameters()).device.type == "cpu" else copy.deepcopy(model).cpu()
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        cpu_model.eval()(x.cpu())
    return int(counter.get_total_flops())


def activation_memory_mb(model: nn.Module, x: torch.Tensor):
    """Peak device memory of one forward above the weights and the input, in MiB; None on the CPU."""
    if x.device.type != "cuda":
        return None
    torch.cuda.synchronize(x.device)
    torch.cuda.reset_peak_memory_stats(x.device)
    base = torch.cuda.memory_allocated(x.device)
    with torch.inference_mode():
        model.eval()(x)
    torch.cuda.synchronize(x.device)
    return (torch.cuda.max_memory_allocated(x.device) - base) / 2**20


def report(config, batch_size=1, height=None, width=None, channels=None, device=None):
    """Everything the CLI prints, as a dict of rows and totals."""
    dev = resolve_device(device)
    img = config.get("dataset", {}).get("img_size", [224, 224])
    img = [img, img] if isinstance(img, int) else list(img)
    h, w = height or img[0], width or img[1]
    c = channels or config["model"].get("in_channels", 3)
    model = create_model(config, device=dev).eval()
    x = torch.zeros((batch_size, c, h, w), device=dev)
    rows, total = count_parameters(model)
    leaf_rows = leaf_parameter_rows(model)
    fl_leaf = leaf_flops_rows(model, x)
    flops = model_flops(model, x)
    n_stats = sum(b.numel() for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var")))
    return {"name": config["model"]["name"], "input": (batch_size, c, h, w), "rows": rows, "total": total,
            "leaf_rows": leaf_rows, "leaf_flops": fl_leaf, "module_flops": module_flops_rows(model, fl_leaf),
            "summary": forward_summary(model, x), "flops": flops, "macs": flops // 2, "bn_stats": n_stats,
            "size_mb": (total + n_stats) * 4 / 2**20, "activation_mb": activation_memory_mb(model, x),
            "device": str(dev)}


def format_report(r) -> str:
    fl_sum = sum(fl for _, fl in r["leaf_flops"])
    lines = [f"Model: {r['name']}", f"Input: {r['input']} (NCHW) on {r['device']}", "",
             f"{'Module':<40}{'Params':>15}{'FLOPs':>18}{'FLOPs%':>9}", "-" * 82]
    for mod, n in r["rows"]:
        fl = r["module_flops"].get(mod, 0)
        lines.append(f"{mod:<40}{n:>15,}{fl:>18,}{100.0 * fl / fl_sum if fl_sum else 0.0:>8.1f}%")
    flops = r["flops"]
    lines += [
        "-" * 82,
        f"{'Total trainable params':<40}{r['total']:>15,}",
        f"{'BatchNorm running stats':<40}{r['bn_stats']:>15,}",
        f"Model size: {r['size_mb']:.2f} MB (float32)",
        f"FLOPs (per forward, counted by FlopCounterMode on the plain versions): {flops:,} ({flops / 1e9:.2f} GFLOPs)",
        f"MACs: {r['macs']:,} ({r['macs'] / 1e9:.2f} GMACs)",
        f"Per-module FLOPs sum (analytic, param ops): {fl_sum:,} ({100.0 * fl_sum / flops:.1f}% of the counted "
        f"total; the rest is param-free products: attention)" if flops else
        f"Per-module FLOPs sum (analytic, param ops): {fl_sum:,}",
    ]
    act = r["activation_mb"]
    lines.append(f"Activation memory (peak of one forward above weights and input, this batch/size/dtype): "
                 f"{act:.1f} MB" if act is not None else "Activation memory: not measured on the CPU")
    fl_of_leaf = dict(r["leaf_flops"])
    lines += ["", "Per-leaf-module parameters + FLOPs:", f"{'Leaf module':<55}{'Params':>15}{'FLOPs':>18}", "-" * 88]
    lines += [f"{mod:<55}{n:>15,}{fl_of_leaf.get(mod, 0):>18,}" for mod, n in r["leaf_rows"]]
    lines += ["", "Architecture summary - one forward, NCHW shapes:",
              f"{'Module':<55}{'Output shape':>24}{'Params':>14}", "-" * 93]
    lines += [f"{mod:<55}{str(shape):>24}{n:>14,}" for mod, shape, n in r["summary"]]
    return "\n".join(lines)


def write_reports(r, text: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{r['name']}_stats")
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write(text + "\n")
    with open(base + ".csv", "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["module", "params", "flops"])
        for mod, n in r["rows"]:
            writer.writerow([mod, n, r["module_flops"].get(mod, 0)])
        writer.writerow(["TOTAL", r["total"], sum(fl for _, fl in r["leaf_flops"])])
        writer.writerow(["flops", r["flops"]])
        writer.writerow(["macs", r["macs"]])
        writer.writerow(["size_mb", f"{r['size_mb']:.2f}"])
        if r["activation_mb"] is not None:
            writer.writerow(["activation_mb", f"{r['activation_mb']:.1f}"])
    with open(base + "_layers.csv", "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["module", "output_shape", "params"])
        for mod, shape, n in r["summary"]:
            writer.writerow([mod, "x".join(map(str, shape)), n])
    try:  # the parameter pie chart (reference model_stats.py:45-68)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        top = sorted(r["rows"], key=lambda row: -row[1])[:10]
        rest = r["total"] - sum(n for _, n in top)
        plt.figure(figsize=(8, 8))
        plt.pie([n for _, n in top] + ([rest] if rest > 0 else []),
                labels=[m for m, _ in top] + (["other"] if rest > 0 else []), autopct="%1.1f%%")
        plt.title(f"{r['name']} parameter distribution")
        plt.savefig(base + "_params_pie.png", bbox_inches="tight")
        plt.close("all")
    except Exception as e:  # a missing font or backend must not cost the statistics
        print(f"(pie chart skipped: {e})")


def main(argv=None):
    p = argparse.ArgumentParser(description="Model parameters / size / FLOPs (PyTorch port)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output", type=str, default="model_stats")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default; raises when CUDA is absent) or cpu")
    args = p.parse_args(argv)
    r = report(load_config(args.config), args.batch_size, args.height, args.width, args.channels, args.device)
    text = format_report(r)
    print(text)
    write_reports(r, text, args.output)
    print(f"Reports written to {args.output}/")
    return r


if __name__ == "__main__":
    main()
