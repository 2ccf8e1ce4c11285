"""Plain PyTorch RMSNorm: the CPU path and the versions the CUDA kernel and
its autograd Function are held against."""
import torch


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    """x [..., d], scale [d] -> x * rsqrt(mean(x^2) + eps) * scale in f32,
    cast to x's dtype: the JAX package's `apply_norm` and `rmsnorm_ref`,
    term for term and in their order."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, *, eps: float = 1e-6):
    """The analytic gradient of `rmsnorm_ref`, in f32 -> (dx in x's dtype,
    dscale in scale's dtype). With r = rsqrt(mean(x^2) + eps) and
    x^ = x r: dscale = sum over rows of dy x^, and dx = r (dy s - x^
    mean(dy s x^)), what JAX's autodiff of the plain `apply_norm` gives."""
    d = x.shape[-1]
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    dscale = (dyf * xhat).reshape(-1, d).sum(dim=0)
    g = dyf * scale.float()
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale.to(scale.dtype)
