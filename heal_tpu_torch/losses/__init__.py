"""Losses (torch): callables ``(output_dict, target_dict, suffix) ->
(total, aux dict)``, registered by their config ``core_method`` name.

Counterparts of heal_tpu/losses, all nine: ``point_pillar_loss``,
``point_pillar_pyramid_loss``, ``point_pillar_uncertainty_loss``,
``point_pillar_disconet_loss``, ``center_point_loss``,
``voxel_net_loss``, ``pixor_loss``, ``ciassd_loss`` and
``fpvrcnn_loss``.
"""
from . import center_point_loss  # noqa: F401
from . import fpvrcnn_loss  # noqa: F401
from . import pixor_loss  # noqa: F401
from . import point_pillar_disconet_loss  # noqa: F401
from . import point_pillar_loss  # noqa: F401
from . import point_pillar_pyramid_loss  # noqa: F401
from . import point_pillar_uncertainty_loss  # noqa: F401
from . import voxel_net_loss  # noqa: F401
from ..models.registry import build_loss

__all__ = ["build_loss"]
