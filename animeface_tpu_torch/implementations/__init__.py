'''Model recipes of the PyTorch port (counterpart of animeface_tpu.implementations).'''
