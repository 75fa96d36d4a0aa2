'''Training utilities of the PyTorch port (counterpart of animeface_tpu.nnutils).'''
