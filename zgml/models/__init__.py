from zgml.models.llama import LlamaConfig, LlamaModel  # noqa: F401
