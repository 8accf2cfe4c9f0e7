"""Every published config builds in the port.

Each YAML under heal_tpu/configs/ (the 136 published and demo configs)
and tests/configs/ loads through the port's loader (its ``yaml_parser``
derives the anchor grid), and builds its model (for the agent axis
``train_params.max_cav``) and its loss. Nothing runs a forward: the
registry, the builders and the modules' constructors are what is held.
"""
import glob
import os

import pytest
import torch

from heal_tpu_torch.config import load_yaml
from heal_tpu_torch.models import build_loss, build_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = sorted(glob.glob(os.path.join(ROOT, "heal_tpu", "configs", "**",
                                          "*.yaml"), recursive=True))
TESTS = sorted(glob.glob(os.path.join(ROOT, "tests", "configs", "*.yaml")))


def test_published_config_count():
    assert len(PUBLISHED) == 136


@pytest.mark.parametrize(
    "path", PUBLISHED + TESTS, ids=lambda p: os.path.relpath(p, ROOT))
def test_config_builds_model_and_loss(path):
    cfg = load_yaml(path)
    model = build_model(cfg["model"],
                        max_cav=cfg["train_params"]["max_cav"])
    assert sum(p.numel() for p in model.parameters()) > 0
    loss = build_loss(cfg["loss"])
    assert callable(loss)
