from mfvit_tpu_torch.models import crossvit_cnn, fusion, gpt_fusion  # noqa: F401
