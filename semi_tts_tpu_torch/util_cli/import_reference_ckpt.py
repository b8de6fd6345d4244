"""Convert a checkpoint of the upstream PyTorch implementation into this
package's checkpoint (the layout `train.checkpoint` shares with the JAX
package), which ``--load``, ``--gen-specgram`` and
`serve.TTSServer.from_checkpoint` read:

    python -m semi_tts_tpu_torch.util_cli.import_reference_ckpt \\
        --config config/semi-multi-spkr-paired-data.yaml \\
        --torch-ckpt /path/to/best_tts_loss.pth --output ckpt/imported/best_tts_loss.pth

The upstream file is the solver triple (``model``, ``optimizer``,
``global_step``) or a bare state_dict. Weights and BatchNorm statistics are
carried exactly (`train.torch_import`), the step too; the optimizer's
moments are not, so a run resumed from the result starts Adam afresh with
its schedule at the carried step. The conversion runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os

from ..bridge import _flatten
from ..data.text import load_text_encoder
from ..models import vqvae as V
from ..train.checkpoint import save_checkpoint
from ..train.solver import PRETRAINED
from ..train.torch_import import import_reference_checkpoint
from ..utils.metrics import read_phn_attr


def model_config(config):
    """(VQVAEConfig, phonological attribute table or None) of an experiment
    YAML's dict, its vocabulary and speaker map."""
    audio, corpus = config["data"]["audio"], config["data"]["corpus"]
    tokenizer = load_text_encoder("phoneme", vocab_file=corpus["vocab_file"])
    with open(corpus["spkr_map"]) as f:
        n_spkr = len(json.load(f))
    model_cfg = {k: v for k, v in config["model"].items() if k not in PRETRAINED}
    phn_attr_pth = model_cfg["codebook"].get("phn_attr_pth") or ""
    phn_attr = read_phn_attr(phn_attr_pth) if phn_attr_pth else None
    cfg = V.config_from_yaml(
        model_cfg, n_mels=audio["num_mels"],
        linear_dim=audio["num_freq"] if audio["use_linear"] else None,
        vocab_size=tokenizer.vocab_size, n_spkr=n_spkr,
        attr_dim=0 if phn_attr is None else phn_attr.shape[1])
    return cfg, phn_attr


def convert(config, torch_ckpt, output, *, lenient=False):
    """Import ``torch_ckpt`` for the model of ``config`` (an experiment
    YAML's dict) and write it to ``output``; returns the checkpoint dict."""
    cfg, phn_attr = model_config(config)
    ckpt = import_reference_checkpoint(torch_ckpt, cfg, phn_attr, strict=not lenient)
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    save_checkpoint(output, params=ckpt["model"], state=ckpt["state"], opt_state=None,
                    step=ckpt["global_step"])
    return ckpt


def parser():
    ap = argparse.ArgumentParser(
        prog="python -m semi_tts_tpu_torch.util_cli.import_reference_ckpt",
        description="Convert an upstream PyTorch checkpoint into this package's checkpoint.")
    ap.add_argument("--config", required=True,
                    help="The experiment YAML the checkpoint was trained with.")
    ap.add_argument("--torch-ckpt", required=True,
                    help="Upstream .pth file (solver triple or state_dict).")
    ap.add_argument("--output", required=True, help="Output checkpoint path (npz, named .pth).")
    ap.add_argument("--lenient", action="store_true",
                    help="Ignore unconsumed checkpoint keys instead of failing.")
    return ap


def main(argv=None):
    import yaml

    args = parser().parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    ckpt = convert(config, args.torch_ckpt, args.output, lenient=args.lenient)
    n = len(_flatten(ckpt["model"]))
    print(f"imported {n} weight tensors (step {ckpt['global_step']}) -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
