"""Where `build_spann3r` puts the model: the card by default, the CPU only
when asked. Whether a card is present is decided inside each test."""
import pytest
import torch

from spann3r_torch import config as TC
from spann3r_torch.models import spann3r as TS


def _tiny_cfg():
    return TC.Spann3RConfig(
        dust3r=TC.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                               enc=TC.ViTConfig(dim=64, depth=1, num_heads=4),
                               dec=TC.ViTConfig(dim=48, depth=1, num_heads=4),
                               head_type="linear"),
        value_enc_depth=1, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        model = TS.build_spann3r(_tiny_cfg())
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.build_spann3r(_tiny_cfg())


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_cpu_on_request(device):
    model = TS.build_spann3r(_tiny_cfg(), device,
                             torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert not model.training
