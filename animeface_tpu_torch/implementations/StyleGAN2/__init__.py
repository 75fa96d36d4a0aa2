'''StyleGAN2 in PyTorch: model, training step, optimizers.'''
