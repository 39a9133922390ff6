"""The gem package surface on the port (the counterpart of the root
``gem.py``): ``from rs_ov_torch import gem; gem.create_gem_model(...)``."""

from rs_ov_torch.factory import get_tokenizer  # noqa: F401
from rs_ov_torch.gem_api import (  # noqa: F401
    GEMWrapper,
    create_gem_model,
    get_gem_img_transform,
    visualize,
)
