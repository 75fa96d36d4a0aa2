'''CIPS in PyTorch: the generator, the recipe's models, its training step and its sampler.'''
