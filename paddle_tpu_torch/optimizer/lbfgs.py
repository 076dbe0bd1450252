"""LBFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``; reference:
python/paddle/optimizer/lbfgs.py): a closure-driven, full-batch
quasi-Newton method with an optional strong-Wolfe line search.

As in the reference, the method is host-driven (the history of (s, y)
pairs and the line-search loop are Python); the inner products and the
direction are torch operations on the parameters' device, in f32 over the
flattened parameters. The reference's rules are kept as they are: the
two-loop recursion with its 1e-10 floors, the curvature guard on a new
pair, the step without a closure pairing successive calls, and the
backtracking line search that halves the step until the (approximate)
strong Wolfe conditions hold, reporting its last evaluated point when
they never do.
"""
import torch

from .optimizer import Optimizer


def _value(loss):
    """A loss (a tensor or a number) as a Python float."""
    return float(loss.detach() if isinstance(loss, torch.Tensor) else loss)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self.max_iter = max_iter
        self.max_eval = (max_eval if max_eval is not None
                         else max_iter * 5 // 4)
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist = []
        self._y_hist = []
        self._prev_x = None
        self._prev_flat_grad = None

    # -- flat helpers --------------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _gather_grads(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in self._params()]).float()

    def _gather_params(self):
        return torch.cat([p.detach().reshape(-1)
                          for p in self._params()]).float()

    @torch.no_grad()
    def _assign_flat(self, flat):
        i = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[i:i + n].reshape(p.shape))
            i += n

    def _clear_grads(self):
        for p in self._params():
            p.grad = None

    def _direction(self, grad):
        """Two-loop recursion over the (s, y) history."""
        q = grad
        alphas = []
        for s, y in reversed(list(zip(self._s_hist, self._y_hist))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            gamma = torch.dot(s, y) / torch.clamp(torch.dot(y, y), min=1e-10)
            q = q * gamma
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def step(self, closure=None):
        """``closure()`` -> the loss, recomputing the forward and backward.
        Without a closure: one LBFGS update from the gradients already on
        the parameters (the secant pair spans successive calls). Returns
        the last loss (None without a closure)."""
        if closure is None:
            grad = self._gather_grads()
            x0 = self._gather_params()
            if self._prev_flat_grad is not None:
                self._update_history(self._prev_x, self._prev_flat_grad, x0,
                                     grad)
            d = self._direction(grad)
            self._assign_flat(x0 + self.get_lr() * d)
            self._prev_x, self._prev_flat_grad = x0, grad
            self._global_step += 1
            return None

        loss = closure()
        grad = self._gather_grads()
        evals = 1
        for _ in range(self.max_iter):
            if float(grad.abs().max()) <= self.tolerance_grad:
                break
            d = self._direction(grad)
            x0 = self._gather_params()
            lr = self.get_lr()
            if self.line_search_fn == "strong_wolfe":
                lr, loss, grad, evals_ls = self._strong_wolfe(
                    closure, x0, d, lr, loss, grad)
                evals += evals_ls
            else:
                self._assign_flat(x0 + lr * d)
                self._clear_grads()
                loss = closure()
                grad_new = self._gather_grads()
                self._update_history(x0, grad, self._gather_params(),
                                     grad_new)
                grad = grad_new
                evals += 1
            if evals >= self.max_eval:
                break
            x_new = self._gather_params()
            if float((x_new - x0).abs().max()) < self.tolerance_change:
                break
        self._global_step += 1
        return loss

    def _update_history(self, x_old, g_old, x_new, g_new):
        # the secant pair s_k = x_{k+1} - x_k, y_k = g_{k+1} - g_k, kept
        # only under positive curvature (H_k stays positive definite)
        s = x_new - x_old
        y = g_new - g_old
        if float(torch.dot(s, y)) > 1e-10:
            self._s_hist.append(s)
            self._y_hist.append(y)
            if len(self._s_hist) > self.history_size:
                self._s_hist.pop(0)
                self._y_hist.pop(0)

    def _strong_wolfe(self, closure, x0, d, lr, f0, g0, c1=1e-4, c2=0.9,
                      max_ls=20):
        """Backtracking line search to the (approximate) strong Wolfe
        conditions: (step, loss, gradient, evaluations)."""
        dg0 = float(torch.dot(g0, d))
        evals = 0
        t = lr
        f_prev = _value(f0)
        for _ in range(max_ls):
            self._assign_flat(x0 + t * d)
            self._clear_grads()
            loss = closure()
            evals += 1
            f_t = _value(loss)
            g_t = self._gather_grads()
            if (f_t <= f_prev + c1 * t * dg0
                    and abs(float(torch.dot(g_t, d))) <= c2 * abs(dg0)):
                self._update_history(x0, g0, x0 + t * d, g_t)
                return t, loss, g_t, evals
            t_eval = t  # the parameters, loss and gradient are this step's
            t *= 0.5
        # exhausted: the last evaluated point (the parameters are there)
        self._update_history(x0, g0, x0 + t_eval * d, g_t)
        return t_eval, loss, g_t, evals

    def _rule(self, p, g, slots, lr, step):
        raise NotImplementedError("LBFGS is closure-driven: call step()")
