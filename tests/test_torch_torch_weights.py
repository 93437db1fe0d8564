"""`utils/torch_weights.py`: a torchvision-keyed ResNet checkpoint, made
here from numpy seeds (nothing is downloaded), grafted onto the port's
image backbone, against the JAX package's converter and graft; and
`Trainer.init_state` with `pretrained_backbone` set."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampire_tpu.models.resnet import ResNet as JaxResNet
from vampire_tpu.utils import torch_weights as jtw
from vampire_tpu_torch.configs import tiny_config
from vampire_tpu_torch.models.resnet import ResNet
from vampire_tpu_torch.training.trainer import Trainer
from vampire_tpu_torch.utils import torch_weights as tw
from vampire_tpu_torch.weights import from_flax


def torchvision_resnet(depth, seed=0):
    """The state dict torchvision's resnet<depth> saves (keys, shapes,
    OIHW kernels, BN statistics, num_batches_tracked, fc), with seeded
    values: He-scaled kernels, BN affines and statistics away from their
    init."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        w = rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (cin * k * k))
        sd[f'{name}.weight'] = torch.from_numpy(w.astype(np.float32))

    def bn(name, c):
        for k, v in (('weight', rng.uniform(0.8, 1.2, c)),
                     ('bias', rng.normal(0.0, 0.1, c)),
                     ('running_mean', rng.normal(0.0, 0.2, c)),
                     ('running_var', rng.uniform(0.5, 1.5, c))):
            sd[f'{name}.{k}'] = torch.from_numpy(v.astype(np.float32))
        sd[f'{name}.num_batches_tracked'] = torch.tensor(1000)

    bottleneck = depth >= 50
    exp = 4 if bottleneck else 1
    conv('conv1', 64, 3, 7)
    bn('bn1', 64)
    cin = 64
    for i, nb in enumerate(tw.STAGE_BLOCKS[depth]):
        planes = 64 * 2 ** i
        for j in range(nb):
            base = f'layer{i + 1}.{j}'
            convs = ([(planes, cin, 1), (planes, planes, 3),
                      (planes * 4, planes, 1)] if bottleneck else
                     [(planes, cin, 3), (planes, planes, 3)])
            for k, (co, ci, ks) in enumerate(convs, 1):
                conv(f'{base}.conv{k}', co, ci, ks)
                bn(f'{base}.bn{k}', co)
            if j == 0 and (i > 0 or cin != planes * exp):
                conv(f'{base}.downsample.0', planes * exp, cin, 1)
                bn(f'{base}.downsample.1', planes * exp)
            cin = planes * exp
    sd['fc.weight'] = torch.from_numpy(
        rng.randn(1000, cin).astype(np.float32))
    sd['fc.bias'] = torch.zeros(1000)
    return sd


def _holder(resnet):
    """What `graft_into_model_` reads: `model.backbone.img_backbone`."""
    return types.SimpleNamespace(
        backbone=types.SimpleNamespace(img_backbone=resnet))


def _seeded(depth):
    m = ResNet(depth=depth)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m.eval()


def test_graft_matches_jax_resnet18():
    """A ResNet-18 at base width 64 on a 64 x 64 image: the port's grafted
    state equals `from_flax` of the JAX-grafted variables bit for bit (the
    JAX converter transposes to HWIO, `from_flax` back), and the two
    eval-mode forwards agree at fp32 tolerance."""
    sd = torchvision_resnet(18)
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    jm = JaxResNet(depth=18)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    bp, bs = jtw.convert_torchvision_resnet(
        {k: v.numpy() for k, v in sd.items()}, 18)
    grafted = jtw.graft_into_variables(
        {'params': {'r': v['params']}, 'batch_stats': {'r': v['batch_stats']}},
        bp, bs, prefix=('r',))
    jv = {'params': grafted['params']['r'],
          'batch_stats': grafted['batch_stats']['r']}
    port = _seeded(18)
    tw.graft_into_model_(_holder(port), tw.convert_torchvision_resnet(sd, 18))
    want = from_flax(jax.device_get(jv), port)
    got = port.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for k, t in tw.convert_torchvision_resnet(sd, 18).items():
        assert torch.equal(got[k], t), k
    jouts = jm.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        touts = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(touts) == len(jouts) == 4
    for t, j in zip(touts, jouts):
        j = np.asarray(j).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())


def test_graft_covers_resnet50():
    """Every parameter and BN statistic of the port's ResNet-50, the
    flagship's image backbone, comes from the torchvision dict (no
    forward); fc and num_batches_tracked are not read."""
    sd = torchvision_resnet(50)
    conv = tw.convert_torchvision_resnet(sd, 50)
    assert not any(k.startswith('fc') or 'num_batches' in k for k in conv)
    port = ResNet(depth=50)
    tw.graft_into_model_(_holder(port), conv)
    own = {k: v for k, v in port.state_dict().items()
           if not k.endswith('num_batches_tracked')}
    assert set(own) == set(conv)
    assert torch.equal(own['layer1_0.downsample.conv.weight'],
                       sd['layer1.0.downsample.0.weight'])
    assert torch.equal(own['layer4_2.conv3.bn.running_var'],
                       sd['layer4.2.bn3.running_var'])
    for k, t in conv.items():
        assert torch.equal(own[k], t), k


def test_graft_raises_and_copies_nothing():
    """A shape mismatch, a missing key and a checkpoint of another depth
    raise, and the model keeps its weights; depth 10 (the tiny configs')
    has no torchvision counterpart: KeyError, as in the JAX converter."""
    sd = torchvision_resnet(18)
    port = _seeded(18)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    conv = tw.convert_torchvision_resnet(sd, 18)
    bad = dict(conv, **{'layer2_0.conv1.conv.weight':
                        torch.zeros(128, 64, 1, 1)})
    with pytest.raises(ValueError, match='layer2_0.conv1.conv.weight'):
        tw.graft_into_model_(_holder(port), bad)
    missing = {k: v for k, v in conv.items()
               if k != 'layer3_1.conv2.bn.running_var'}
    with pytest.raises(KeyError, match='1 backbone tensors missing'):
        tw.graft_into_model_(_holder(port), missing)
    with pytest.raises(KeyError, match='not in the backbone'):
        tw.graft_into_model_(_holder(port), tw.convert_torchvision_resnet(
            torchvision_resnet(34), 34))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(KeyError):
        tw.convert_torchvision_resnet(sd, 10)
    with pytest.raises(KeyError):
        jtw.convert_torchvision_resnet({k: v.numpy() for k, v in sd.items()},
                                       10)


def test_init_state_grafts_the_pth(tmp_path, capsys):
    """`init_state` under a tiny config with img_backbone_depth=18 grafts a
    .pth the test writes: every image-backbone tensor is the file's after
    the seeded init, and the JAX package's message is printed. A bad path
    raises."""
    sd = torchvision_resnet(18, seed=3)
    path = tmp_path / 'r18.pth'
    torch.save(sd, path)
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, img_backbone_depth=18),
        train=dataclasses.replace(cfg.train, pretrained_backbone=str(path)))
    tr = Trainer(cfg, workdir=str(tmp_path), device='cpu')
    state = tr.init_state(None, 1)
    assert (f'image backbone: torchvision weights grafted from {path}'
            in capsys.readouterr().out)
    own = state.model.backbone.img_backbone.state_dict()
    for k, t in tw.convert_torchvision_resnet(sd, 18).items():
        assert torch.equal(own[k], t), k
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pretrained_backbone=str(tmp_path / 'none.pth')))
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, workdir=str(tmp_path), device='cpu').init_state(None, 1)
