'''CIPS in PyTorch: the generator, the recipe's models and its sampler.'''
