"""The port's command-line tools, run as `python -m
fabric_token_sdk_tpu_torch.cmd.<tool>`."""
