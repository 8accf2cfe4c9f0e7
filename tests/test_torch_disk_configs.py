"""Every published config that names a disk dataset, in the port, on
the CPU.

The 121 YAML files under heal_tpu/configs with ``fusion.dataset`` opv2v,
v2xset, dairv2x or v2xsim (the 120 of opv2v/, v2xset/, dairv2x/, v2xsim/
and exemplar.yaml) each build their dataset on the matching small tree
of tests/test_torch_backends.py (its directories pointed there, nothing
else changed) and assemble their first test sample, one case each. The
published camera configs give only ``final_dim``, ``cams`` and ``Ncams``
in their ``data_aug_conf``: heal_tpu stops at ``KeyError: 'H'`` (ROADMAP
§3), the port raises a ValueError naming the missing keys, and with the
keys added (AUG_KEYS: the written images' size and the demo alliance's
crop policy) the port assembles the sample from the images on disk.
"""
import copy
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.tools.train import load_config
from test_torch_backends import (  # noqa: F401 (fixtures)
    CONFIGS, _add_aug_keys, _point_at, jax_native, trees)

torch.set_num_threads(1)


def _disk_configs():
    out = []
    for path in sorted(glob.glob(os.path.join(CONFIGS, "**", "*.yaml"),
                                 recursive=True)):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        dataset = (cfg.get("fusion") or {}).get("dataset")
        if dataset in ("opv2v", "v2xset", "dairv2x", "v2xsim"):
            out.append(os.path.relpath(path, CONFIGS))
    return out


DISK_CONFIGS = _disk_configs()


def test_the_disk_configs_are_the_published_ones():
    names = [p.split(os.sep)[0] for p in DISK_CONFIGS]
    assert {n: names.count(n) for n in set(names)} == {
        "opv2v": 65, "dairv2x": 32, "v2xset": 18, "v2xsim": 5,
        "exemplar.yaml": 1}


@pytest.mark.parametrize("rel", DISK_CONFIGS)
def test_every_disk_config_assembles(rel, trees, jax_native):
    """The config's dataset on its tree, the first test sample. A camera
    config that lacks the image size and crop policy: heal_tpu raises
    KeyError 'H', the port a ValueError naming the keys; with AUG_KEYS
    added the port assembles."""
    cfg = load_config(os.path.join(CONFIGS, rel))
    cfg = _point_at(cfg, cfg["fusion"]["dataset"], trees)
    try:
        sample = build_dataset(copy.deepcopy(cfg), train=False)[0]
        from_disk = False
    except ValueError as e:
        assert "data_aug_conf lacks" in str(e)
        with pytest.raises(KeyError, match="'H'"):
            jax_build_dataset(copy.deepcopy(cfg), train=False)[0]
        sample = build_dataset(_add_aug_keys(cfg), train=False)[0]
        from_disk = True
    # late fusion: the ego's sample and one per other agent
    samples = [sample] + sample.get("agent_samples", [])
    if from_disk:
        assert any(np.abs(v["imgs"]).sum() > 0 for s in samples
                   for k, v in s.items()
                   if k.startswith("inputs_") and "imgs" in v)
    assert sample["point_mask"].any() and sample["gt_mask"].sum() > 0
    assert np.isfinite(sample["gt_boxes"]).all()
