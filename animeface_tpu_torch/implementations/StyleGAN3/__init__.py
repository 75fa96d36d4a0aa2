'''StyleGAN3 in PyTorch: model, training step, optimizers.'''
