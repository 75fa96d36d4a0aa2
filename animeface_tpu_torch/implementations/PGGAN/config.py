'''Per-resolution schedules (the port's copy of
`animeface_tpu/implementations/PGGAN/config.py`).'''

resl2lr = {4: 0.001, 8: 0.001, 16: 0.001, 32: 0.001, 64: 0.001, 128: 0.001}
betas = (0.0, 0.99)
resl2batch_size = {4: 32, 8: 32, 16: 32, 32: 32, 64: 32, 128: 16}
resl2num = {4: 1, 8: 2, 16: 3, 32: 4, 64: 4, 128: 4}  # epochs per phase
