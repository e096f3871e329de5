from .base_model import BaseModel  # noqa: F401
