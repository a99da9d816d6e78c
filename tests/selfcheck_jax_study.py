"""The self-check's recipe trained by the JAX package and by the port from
one init, on the CPU: is the port's mAP the JAX package's, up to the
spread of the recipe?

    JAX_PLATFORMS=cpu python tests/selfcheck_jax_study.py --init port --seed 0 [--workdir DIR]

For one seed, the init (``port``: the port's seeded init,
``init_weights`` at ``seed``; ``jax``: the JAX package's ``model.init``
at ``PRNGKey(seed)``, as its trainer draws it) is written as a JAX weight
directory (``save_params``). Both trainers start from it
(``train_unfreeze``, ``freeze=False``), with the self-check's recipe at
that seed (150 epochs) on the self-check's data, both decoding with PIL
and the port on 2 threads (four pairs share 8 cores). Each
trained model is evaluated by its own package; the JAX weights by the
port's evaluator too (it reads the directory), which holds the two
evaluations against each other. Prints ``STUDY {...}`` with the mAPs
and the first and last per-epoch losses. Not a test: a 150-epoch run of
both packages takes minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--init", choices=("port", "jax"), required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None)
    a = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(2)
    from _torch_parity import to_flax
    from test_torch_data import pinned_decoder
    from yoloret_tpu.configs import RunConfig as JaxRunConfig
    from yoloret_tpu.data import Dataset as JaxDataset
    from yoloret_tpu.data import DatasetMode as JaxDatasetMode
    from yoloret_tpu.data import load_anchors as jax_load_anchors
    from yoloret_tpu.eval import evaluate_map as jax_evaluate_map
    from yoloret_tpu.infer import Predictor as JaxPredictor
    from yoloret_tpu.nn import build_detector
    from yoloret_tpu.train.trainer import train as jax_train
    from yoloret_tpu.utils.checkpoint import save_params
    from yoloret_tpu_torch.nn.detector import YoloReT
    from yoloret_tpu_torch.nn.layers import init_weights
    from yoloret_tpu_torch.tools import selfcheck
    from yoloret_tpu_torch.tools.accuracy_gate import epoch_records
    from yoloret_tpu_torch.train.trainer import train

    root = a.workdir or tempfile.mkdtemp(prefix=f"selfcheck_study_{a.init}{a.seed}_")
    os.makedirs(root, exist_ok=True)
    ann, classes, anchors = selfcheck.build_synthetic(root)
    cfg = selfcheck.selfcheck_cfg(root, ann, classes, anchors, epochs=150, seed=a.seed)
    size = cfg.input_size
    jm = build_detector(cfg.backbone, num_classes=2, dtype=jnp.float32, remat=cfg.remat,
                        rfcr=cfg.rfcr)
    init = os.path.join(root, "init")
    if a.init == "jax":
        v = jm.init(jax.random.PRNGKey(a.seed), jnp.zeros((1, *size, 3), jnp.float32), False)
        v = jax.device_get(v)
    else:
        m = YoloReT(cfg.backbone, num_classes=2, rfcr=cfg.rfcr)
        init_weights(m, torch.Generator().manual_seed(a.seed))
        shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, *size, 3)), False),
                                jax.random.PRNGKey(0))
        v = to_flax({k: dict(t) for k, t in shapes.items()}, m.state_dict())
    save_params(init, {"params": v["params"], "batch_stats": v["batch_stats"]})

    pcfg = cfg.replace(train_unfreeze=init, log_dir=os.path.join(root, "port_logs"))
    jcfg = JaxRunConfig(**{f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)})
    jcfg = jcfg.replace(log_dir=os.path.join(root, "jax_logs"))
    with pinned_decoder("pil", pathlib.Path(root)):
        port_weights = train(pcfg, device="cpu")
        jax_weights = jax_train(jcfg)
        port_map = selfcheck.evaluate(port_weights, ann, anchors, device="cpu", verbose=False)
        port_eval_of_jax = selfcheck.evaluate(jax_weights, ann, anchors, device="cpu",
                                              verbose=False)
        anc = jax_load_anchors(anchors)
        pred = JaxPredictor(backbone=cfg.backbone, weights=jax_weights,
                            class_names=["red", "green"], anchors=anc, input_hw=size,
                            score_threshold=0.0, bf16=False)
        ds = JaxDataset(ann, batch_size=cfg.batch_size, anchors=anc, num_classes=2,
                        input_hw=size, mode=JaxDatasetMode.TEST)
        jax_map = jax_evaluate_map(pred.model, pred.variables, ds, anc, ["red", "green"],
                                   verbose=False)[0]
    losses = {name: [r["loss"] for r in epoch_records(os.path.dirname(w))]
              for name, w in (("port", port_weights), ("jax", jax_weights))}
    print("STUDY " + json.dumps(dict(
        init=a.init, seed=a.seed, port_map=float(port_map),
        jax_map=float(jax_map), port_eval_of_jax=float(port_eval_of_jax),
        port_losses=[losses["port"][0], losses["port"][-1]],
        jax_losses=[losses["jax"][0], losses["jax"][-1]])), flush=True)


if __name__ == "__main__":
    main()
