"""Version and registry constants: the port's copy of the JAX package's
``version.py`` values that the CLIs' flag tables and log names use."""

# model/code version written into log and checkpoint names, equal to the
# JAX package's so that the two packages' files are mutually identifiable
VER = "0.5.7"
SEG_VER = "0.5.6"

DATASETS = ["MNIST", "EMNIST", "CIFAR10", "CIFAR100", "ImageNet", "ImageNet.S3",
            "Zarr", "Histology"]

OPTIMIZERS = ["Adam", "SGD"]
