"""Camera models: projection (ray -> pixel) and lifting (pixel -> ray).

PyTorch port of `ctrlvio_tpu/models/cameras.py` (the camodocal family):
`Pinhole` (radial-tangential), `Equidistant` (Kannala-Brandt fisheye, the
TUM-RSVI model), `Mei` (unified omnidirectional) and `Scaramuzza` (OCam).
Functions take tensors batched over leading axes; inverse distortion runs a
fixed number of Newton / fixed-point iterations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Pinhole:
    fx: float; fy: float; cx: float; cy: float
    k1: float = 0.0; k2: float = 0.0; p1: float = 0.0; p2: float = 0.0

    def distort(self, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([x * rad + dx, y * rad + dy], dim=-1)

    def project(self, X):
        """Camera-frame points (..., 3) -> pixels (..., 2)."""
        xy = X[..., :2] / X[..., 2:3]
        d = self.distort(xy)
        return torch.stack([self.fx * d[..., 0] + self.cx,
                            self.fy * d[..., 1] + self.cy], dim=-1)

    def lift(self, uv, iters: int = 20):
        """Pixels (..., 2) -> normalized coords (..., 2) (z=1 ray)."""
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], dim=-1)
        x = xd
        for _ in range(iters):
            xi, yi = x[..., 0], x[..., 1]
            r2 = xi * xi + yi * yi
            rad = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
            dx = 2.0 * self.p1 * xi * yi + self.p2 * (r2 + 2.0 * xi * xi)
            dy = self.p1 * (r2 + 2.0 * yi * yi) + 2.0 * self.p2 * xi * yi
            x = torch.stack([(xd[..., 0] - dx) / rad, (xd[..., 1] - dy) / rad],
                            dim=-1)
        return x


@dataclass(frozen=True)
class Equidistant:
    """Kannala-Brandt: theta_d = theta + k2 th^3 + k3 th^5 + k4 th^7 + k5 th^9."""

    mu: float; mv: float; u0: float; v0: float
    k2: float = 0.0; k3: float = 0.0; k4: float = 0.0; k5: float = 0.0

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k2 + t2 * (self.k3 + t2 * (
            self.k4 + t2 * self.k5))))

    def project(self, X):
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        td = self._theta_d(theta)
        small = r < 1e-12
        r_safe = torch.where(small, 1.0, r)
        scale = torch.where(small, 0.0, td / r_safe)
        return torch.stack([self.mu * scale * x + self.u0,
                            self.mv * scale * y + self.v0], dim=-1)

    def lift(self, uv, iters: int = 10):
        """Invert theta_d(theta) by Newton; normalized plane coords."""
        pu = (uv[..., 0] - self.u0) / self.mu
        pv = (uv[..., 1] - self.v0) / self.mv
        td = torch.sqrt(pu * pu + pv * pv)
        theta = td
        for _ in range(iters):
            t2 = theta * theta
            f = self._theta_d(theta) - td
            df = 1.0 + t2 * (3 * self.k2 + t2 * (5 * self.k3 + t2 * (
                7 * self.k4 + t2 * 9 * self.k5)))
            theta = theta - f / df
        small = td < 1e-12
        td_safe = torch.where(small, 1.0, td)
        s = torch.where(small, 0.0, torch.sin(theta) / td_safe)
        z = torch.cos(theta)
        z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return torch.stack([s * pu / z_safe, s * pv / z_safe], dim=-1)


@dataclass(frozen=True)
class Mei:
    """Unified omnidirectional (CataCamera): unit sphere with offset xi,
    then radtan distortion, then pinhole."""

    xi: float
    fx: float; fy: float; cx: float; cy: float
    k1: float = 0.0; k2: float = 0.0; p1: float = 0.0; p2: float = 0.0

    def _distort(self, x, y):
        r2 = x * x + y * y
        rad = self.k1 * r2 + self.k2 * r2 * r2
        dx = x * rad + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = y * rad + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return x + dx, y + dy

    def project(self, X):
        n = torch.linalg.vector_norm(X, dim=-1)
        z = X[..., 2] + self.xi * n
        x = X[..., 0] / z
        y = X[..., 1] / z
        xd, yd = self._distort(x, y)
        return torch.stack([self.fx * xd + self.cx, self.fy * yd + self.cy],
                           dim=-1)

    def lift(self, uv, iters: int = 8):
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        x, y = mx, my
        for _ in range(iters):
            xd, yd = self._distort(x, y)
            x = x + (mx - xd)
            y = y + (my - yd)
        xi = self.xi
        r2 = x * x + y * y
        lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * r2)) / (1.0 + r2)
        z = lam - xi
        z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        return torch.stack([lam * x / z_safe, lam * y / z_safe], dim=-1)


@dataclass(frozen=True)
class Scaramuzza:
    """Omnidirectional OCam model: forward polynomial `poly` (sensor radius
    -> ray z) and inverse polynomial `inv_poly` (incidence angle -> sensor
    radius), with the affine sensor transform (c, d; e, 1) + center."""

    poly: tuple
    inv_poly: tuple
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0
    cx: float = 0.0
    cy: float = 0.0

    def project(self, X):
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        norm = torch.sqrt(x * x + y * y)
        norm_s = torch.where(norm > 1e-12, norm, torch.full_like(norm, 1e-12))
        theta = torch.atan2(-z, norm)
        rho = torch.zeros_like(theta)
        for k in reversed(self.inv_poly):
            rho = rho * theta + k
        xn0 = x / norm_s * rho
        xn1 = y / norm_s * rho
        return torch.stack([xn0 * self.c + xn1 * self.d + self.cx,
                            xn0 * self.e + xn1 + self.cy], dim=-1)

    def lift(self, uv):
        xc0 = uv[..., 0] - self.cx
        xc1 = uv[..., 1] - self.cy
        inv_scale = 1.0 / (self.c - self.d * self.e)
        xa = inv_scale * (xc0 - self.d * xc1)
        ya = inv_scale * (-self.e * xc0 + self.c * xc1)
        phi = torch.sqrt(xa * xa + ya * ya)
        z = torch.zeros_like(phi)
        for k in reversed(self.poly):
            z = z * phi + k
        zf = -z
        zf = torch.where(torch.abs(zf) > 1e-9, zf, torch.full_like(zf, 1e-9))
        return torch.stack([xc0 / zf, xc1 / zf], dim=-1)


def fit_inv_poly(poly, rho_max: float, deg: int = 19) -> tuple:
    """Least-squares fit of the inverse polynomial rho(theta) from the
    forward `poly` (numpy, host-side)."""
    rho = np.linspace(1e-3, rho_max, 2048)
    z = np.zeros_like(rho)
    for k in reversed(poly):
        z = z * rho + k
    theta = np.arctan2(z, rho)
    V = np.stack([theta**i for i in range(deg + 1)], axis=1)
    coef, *_ = np.linalg.lstsq(V, rho, rcond=None)
    return tuple(coef.tolist())


def from_yaml_dict(d: dict):
    """CameraFactory: build a camera from the reference's YAML dict."""
    mt = d.get("model_type", "PINHOLE").upper()
    if mt == "KANNALA_BRANDT":
        pp = d["projection_parameters"]
        return Equidistant(mu=pp["mu"], mv=pp["mv"], u0=pp["u0"], v0=pp["v0"],
                           k2=pp["k2"], k3=pp["k3"], k4=pp["k4"], k5=pp["k5"])
    if mt == "PINHOLE":
        pp = d["projection_parameters"]
        dd = d.get("distortion_parameters", {})
        return Pinhole(fx=pp["fx"], fy=pp["fy"], cx=pp["cx"], cy=pp["cy"],
                       k1=dd.get("k1", 0.0), k2=dd.get("k2", 0.0),
                       p1=dd.get("p1", 0.0), p2=dd.get("p2", 0.0))
    if mt == "MEI":
        mp = d["mirror_parameters"]
        pp = d["projection_parameters"]
        dd = d.get("distortion_parameters", {})
        return Mei(xi=mp["xi"], fx=pp["gamma1"], fy=pp["gamma2"],
                   cx=pp["u0"], cy=pp["v0"], k1=dd.get("k1", 0.0),
                   k2=dd.get("k2", 0.0), p1=dd.get("p1", 0.0),
                   p2=dd.get("p2", 0.0))
    if mt == "SCARAMUZZA":
        pol = d["poly_parameters"]
        ipol = d["inv_poly_parameters"]
        af = d["affine_parameters"]
        return Scaramuzza(
            poly=tuple(float(pol[f"p{i}"]) for i in range(5)),
            inv_poly=tuple(float(ipol[f"p{i}"]) for i in range(20)),
            c=float(af["ac"]), d=float(af["ad"]), e=float(af["ae"]),
            cx=float(af["cx"]), cy=float(af["cy"]))
    raise ValueError(f"unknown camera model {mt}")
