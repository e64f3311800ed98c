from oai_analysis_2_tpu_torch.utils.checkpoint import (
    convert_torch_unet_state_dict,
    initialize_model,
    load_checkpoint,
    save_checkpoint,
    weight_from_truth,
)
from oai_analysis_2_tpu_torch.utils.config import ParameterDict, load_json_to_dict

__all__ = [
    "convert_torch_unet_state_dict",
    "initialize_model",
    "load_checkpoint",
    "save_checkpoint",
    "weight_from_truth",
    "ParameterDict",
    "load_json_to_dict",
]
