"""open_clip facade over the port (the counterpart of the root ``open_clip``
package): the names it exports, from the port's modules, so open_clip user
code runs on the port with ``import rs_ov_torch.open_clip as open_clip``."""

from rs_ov_torch.core.config import get_model_config, list_models  # noqa: F401
from rs_ov_torch.factory import (  # noqa: F401
    OPENAI_MEAN as OPENAI_DATASET_MEAN,
    OPENAI_STD as OPENAI_DATASET_STD,
    CLIPModel,
    PreprocessCfg,
    create_loss,
    create_model,
    create_model_and_transforms,
    create_model_from_pretrained,
    get_tokenizer,
    image_transform,
    image_transform_v2,
)
from rs_ov_torch.hub import generate_readme, push_to_hf_hub  # noqa: F401
from rs_ov_torch.pretrained import (  # noqa: F401
    get_pretrained_cfg,
    get_pretrained_url,
    is_pretrained_cfg,
    list_pretrained,
    list_pretrained_models_by_tag,
    list_pretrained_tags_by_model,
)
from rs_ov_torch.text import tokenizer  # noqa: F401
from rs_ov_torch.text.tokenizer import SimpleTokenizer, tokenize  # noqa: F401
from rs_ov_torch.text.zero_shot_metadata import (  # noqa: F401
    IMAGENET_CLASSNAMES,
    OPENAI_IMAGENET_TEMPLATES,
    SIMPLE_IMAGENET_TEMPLATES,
)

# the open_clip surface version this facade tracks, as the root facade's
__version__ = "2.24.0"
