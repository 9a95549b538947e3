"""The port's executable theory (``repro_torch.core.theory``) against the
reference: every closed form within 1e-12 relative, the Monte-Carlo
estimate bitwise on the same generator (which it leaves in the same
state)."""
import numpy as np
import pytest

from repro.core import theory as rth
from repro_torch.core import theory as tth

REL = 1e-12


def close(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0.0) or got == want


@pytest.mark.parametrize("x,delta,beta,eta", [(0, 0.5, 2.0, 0.4),
                                              (3, 0.5, 2.0, 0.4),
                                              (12, 1.3, 0.7, 0.05)])
def test_g_and_h(x, delta, beta, eta):
    close(tth.g_i(x, delta, beta, eta), rth.g_i(x, delta, beta, eta))
    close(tth.h_tau(x, delta, beta, eta), rth.h_tau(x, delta, beta, eta))


@pytest.mark.parametrize("t,tau", [(120, 5), (120, 60), (37, 10), (1, 1)])
@pytest.mark.parametrize("omega", [0.5, 0.0])
def test_theorem1_bound(t, tau, omega):
    kw = dict(delta_i=0.5, beta=2.0, eta=0.4, rho=1.0, omega=omega)
    close(tth.theorem1_bound(t, tau, **kw), rth.theorem1_bound(t, tau, **kw))
    with pytest.raises(AssertionError):
        tth.theorem1_bound(t, tau, **{**kw, "eta": 1.0})


@pytest.mark.parametrize("G", [0.0, 1e-3, 4.0, 250.0])
def test_lemma1_delta(G):
    close(tth.lemma1_delta(G, 0.3, 1.1, 5e4, 0.02),
          rth.lemma1_delta(G, 0.3, 1.1, 5e4, 0.02))


@pytest.mark.parametrize("C,mu", [(0.2, 1.0), (0.6, 1.0), (2.5, 3.0),
                                  (1.0, 1.0), (4.0, 1.0)])
def test_dm1_queue(C, mu):
    close(tth.dm1_phi(C, mu), rth.dm1_phi(C, mu))
    close(tth.dm1_wait(C, mu), rth.dm1_wait(C, mu))


@pytest.mark.parametrize("mu,sigma", [(0.5, 0.5), (1.0, 2.0), (3.0, 1.0),
                                      (1.0, 1e-9)])
def test_theorem2_capacity(mu, sigma):
    close(tth.theorem2_capacity(mu, sigma), rth.theorem2_capacity(mu, sigma))


@pytest.mark.parametrize("C", [0.5, 1.0, 4.0])
@pytest.mark.parametrize("k", [1, 2, 5, 12])
def test_theorem5_closed_form(C, k):
    close(tth.theorem5_savings_k(C, k), rth.theorem5_savings_k(C, k))


@pytest.mark.parametrize("k", [1, 4])
def test_theorem5_monte_carlo_bitwise(k):
    rr, rg = np.random.default_rng(k), np.random.default_rng(k)
    assert tth.expected_savings_mc(2.0, k, rg, n_samples=5000) == \
        rth.expected_savings_mc(2.0, k, rr, n_samples=5000)
    assert rr.random() == rg.random()


@pytest.mark.parametrize("n,gamma_exp,kmax", [(50, 2.5, None),
                                              (20, 2.1, 7)])
def test_scale_free_hist_and_network_savings(n, gamma_exp, kmax):
    got = tth.scale_free_degree_hist(n, gamma_exp, kmax)
    want = rth.scale_free_degree_hist(n, gamma_exp, kmax)
    assert list(got) == list(want)
    for k in want:
        close(got[k], want[k])
    close(tth.theorem5_network_savings(1.7, got),
          rth.theorem5_network_savings(1.7, want))


@pytest.mark.parametrize("k,f", [(1, 1.0), (3, 0.4), (9, 2.0)])
def test_offload_probability(k, f):
    close(tth.offload_probability(k, f), rth.offload_probability(k, f))


@pytest.mark.parametrize("neighbours", [False, True])
def test_theorem6_expected_violations(neighbours):
    hist = rth.scale_free_degree_hist(30, 2.5, 8)
    caps = np.random.default_rng(0).uniform(0.5, 3.0, 4000)
    pk = ({k: {m: 1.0 / 8 for m in range(1, 9)} for k in hist}
          if neighbours else None)
    close(tth.theorem6_expected_violations(hist, 30, 1.2, caps, pk),
          rth.theorem6_expected_violations(hist, 30, 1.2, caps, pk))
