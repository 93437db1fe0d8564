"""ResNet, SECONDFPN, Unet3D, the field backbone and the detection head."""
