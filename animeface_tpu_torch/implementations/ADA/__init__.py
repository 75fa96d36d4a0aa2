'''The ADA recipe (StyleGAN3 + AugmentPipe) in PyTorch: its training step.'''
