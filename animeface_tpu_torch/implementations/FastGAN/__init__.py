'''FastGAN in PyTorch: the SLE generator, the self-supervised D and the recipe's step.'''
