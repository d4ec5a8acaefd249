from zgml.data.mnist import load_mnist, write_synthetic_mnist  # noqa: F401
from zgml.data.dataloader import DataLoader  # noqa: F401
