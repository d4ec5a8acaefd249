from zgml.io.gguf import GGUFFile, GGUFWriter, GGMLType  # noqa: F401
