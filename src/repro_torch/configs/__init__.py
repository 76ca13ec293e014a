"""Architecture registry of the port: importing this package registers every
config the port serves."""
from repro_torch.configs import qwen3_8b  # noqa: F401
