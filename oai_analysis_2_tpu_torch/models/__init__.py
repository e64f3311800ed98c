from oai_analysis_2_tpu_torch.models.unet3d import (
    NETWORK_SPECS,
    UNet3D,
    UNetSpec,
    get_available_networks,
    get_network,
)

__all__ = [
    "NETWORK_SPECS",
    "UNet3D",
    "UNetSpec",
    "get_available_networks",
    "get_network",
]
