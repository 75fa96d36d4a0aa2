'''The port's CLI arguments against the JAX package's: the global parser's
defaults and each recipe's (StyleGAN2, StyleGAN3, ADA, CIPS, FastGAN,
DCGAN, GAN, WGAN, WGAN_gp, PGGAN, StyleGAN, BigGAN, SEBigGAN), exactly;
the flags whose feature is not ported refuse a non-default value; an
unknown recipe (or one the port has no CLI for yet, as EigenGAN) gets the
list of those that have a CLI and exit code 2; without a card and
without ANIMEFACE_PLATFORM=cpu the CLI fails instead of training on the
CPU.'''

import argparse
import pathlib
import subprocess
import sys

import pytest

from animeface_tpu.implementations.ADA import utils as j_ada
from animeface_tpu.implementations.BigGAN import utils as j_biggan
from animeface_tpu.implementations.CIPS import utils as j_cips
from animeface_tpu.implementations.DCGAN import utils as j_dcgan
from animeface_tpu.implementations.FastGAN import utils as j_fastgan
from animeface_tpu.implementations.GAN import utils as j_gan
from animeface_tpu.implementations.PGGAN import utils as j_pggan
from animeface_tpu.implementations.SEBigGAN import utils as j_sebiggan
from animeface_tpu.implementations.StyleGAN import utils as j_sg1
from animeface_tpu.implementations.StyleGAN2 import utils as j_sg2
from animeface_tpu.implementations.StyleGAN3 import utils as j_sg3
from animeface_tpu.implementations.WGAN import utils as j_wgan
from animeface_tpu.implementations.WGAN_gp import utils as j_wgan_gp
from animeface_tpu.utils import argument as j_argument

from animeface_tpu_torch import __main__ as cli
from animeface_tpu_torch.implementations.ADA import utils as t_ada
from animeface_tpu_torch.implementations.BigGAN import utils as t_biggan
from animeface_tpu_torch.implementations.CIPS import utils as t_cips
from animeface_tpu_torch.implementations.DCGAN import utils as t_dcgan
from animeface_tpu_torch.implementations.FastGAN import utils as t_fastgan
from animeface_tpu_torch.implementations.GAN import utils as t_gan
from animeface_tpu_torch.implementations.PGGAN import utils as t_pggan
from animeface_tpu_torch.implementations.SEBigGAN import utils as t_sebiggan
from animeface_tpu_torch.implementations.StyleGAN import utils as t_sg1
from animeface_tpu_torch.implementations.StyleGAN2 import utils as t_sg2
from animeface_tpu_torch.implementations.StyleGAN3 import utils as t_sg3
from animeface_tpu_torch.implementations.WGAN import utils as t_wgan
from animeface_tpu_torch.implementations.WGAN_gp import utils as t_wgan_gp
from animeface_tpu_torch.utils import argument as t_argument

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPES = {'StyleGAN2': (j_sg2, t_sg2), 'StyleGAN3': (j_sg3, t_sg3), 'ADA': (j_ada, t_ada),
           'CIPS': (j_cips, t_cips), 'FastGAN': (j_fastgan, t_fastgan),
           'DCGAN': (j_dcgan, t_dcgan), 'GAN': (j_gan, t_gan), 'WGAN': (j_wgan, t_wgan),
           'WGAN_gp': (j_wgan_gp, t_wgan_gp), 'PGGAN': (j_pggan, t_pggan),
           'StyleGAN': (j_sg1, t_sg1), 'BigGAN': (j_biggan, t_biggan),
           'SEBigGAN': (j_sebiggan, t_sebiggan)}


class _Parsed(Exception):
    pass


def recipe_parser_defaults(argument, module, name):
    '''The defaults of the parser that `module.main(parser)` builds: its
    `parse_args` is stopped, then the parser parses just the name.'''
    parser = argument.get_default_parser()

    def stop(*args, **kwargs):
        raise _Parsed()

    parser.parse_args = stop
    with pytest.raises(_Parsed):
        module.main(parser)
    return vars(argparse.ArgumentParser.parse_args(parser, [name]))


def test_global_parser_defaults_match_jax():
    want = vars(j_argument.get_default_parser().parse_args(['X']))
    got = vars(t_argument.get_default_parser().parse_args(['X']))
    assert got == want


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_recipe_parser_defaults_match_jax(name):
    jax_module, port_module = RECIPES[name]
    want = recipe_parser_defaults(j_argument, jax_module, name)
    assert recipe_parser_defaults(t_argument, port_module, name) == want
    assert vars(port_module.default_args()) == want
    assert vars(port_module.default_args(image_size=64)) == dict(want, image_size=64)
    with pytest.raises(TypeError):
        port_module.default_args(no_such_flag=1)


@pytest.mark.parametrize('flags', [('--mesh', '2'), ('--mesh', '1', '2'), ('--multihost',),
                                   ('--device-data',), ('--profile',)])
def test_deferred_flags_refuse_a_value(flags, monkeypatch):
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item'):
        cli.main(['StyleGAN2', '--synthetic-data', *flags])


@pytest.mark.parametrize('mesh', [['-1'], ['1']])
def test_one_device_mesh_is_accepted(mesh):
    args = t_argument.get_default_parser().parse_args(['X', '--mesh', *mesh])
    t_argument.refuse_deferred(args)


@pytest.mark.parametrize('name', ['NoSuchModel', 'EigenGAN'])
def test_unknown_recipe_exits_2(name, monkeypatch, capsys):
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')
    with pytest.raises(SystemExit) as e:
        cli.main([name])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert name in err
    for recipe in ('ADA', 'BigGAN', 'CIPS', 'DCGAN', 'FastGAN', 'GAN', 'PGGAN', 'SEBigGAN',
                   'StyleGAN', 'StyleGAN2', 'StyleGAN3', 'WGAN', 'WGAN_gp'):
        assert recipe in err


def test_cli_without_card_or_cpu_flag_fails():
    code = ('import runpy, sys, torch\n'
            'torch.cuda.is_available = lambda: False\n'
            "sys.argv = ['animeface_tpu_torch', 'ADA', '--synthetic-data']\n"
            "runpy.run_module('animeface_tpu_torch', run_name='__main__')\n")
    env = {k: v for k, v in __import__('os').environ.items() if k != 'ANIMEFACE_PLATFORM'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert 'no CUDA device is available' in out.stderr
    assert 'Traceback' not in out.stderr
