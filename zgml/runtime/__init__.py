from zgml.runtime.profile import global_profile, RuntimeProfile  # noqa: F401
