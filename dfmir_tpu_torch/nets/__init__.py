"""Networks: the ResNet generator (netG) and VxmDense (netR)."""
