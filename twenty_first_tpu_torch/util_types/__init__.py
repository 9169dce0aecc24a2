from .sponge import Domain, Sponge  # noqa: F401
