"""Plain fp32 PyTorch reference of the DistDiff expansion: the UNet, the
VAE, the ResNet-50 guide and the recipe. Independent of the program under
test; it reads the program's outputs only to judge them."""
