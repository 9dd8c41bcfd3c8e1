// Python bindings of the kernels' C launchers, for the
// torch.utils.cpp_extension build.  Pointers and the CUDA stream travel as
// integers (tensor.data_ptr(), stream.cuda_stream), so the Python wrappers
// call this module and the ctypes build the same way.  Only pybind11 is
// included: PyTorch's own headers would add minutes to the build.

#include <pybind11/pybind11.h>

#include <cstdint>
#include <stdexcept>

extern "C" int madpp_tracker_step(
    const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, void*, void*, void*, int, int, int, int,
    float, int, int, void*);
extern "C" long long madpp_tracker_scratch(int, int, int);
extern "C" int madpp_tracker_cluster(int, int, int);

extern "C" int madpp_kalman_step(const void*, const void*, const void*, const void*,
                                 const void*, const void*, const void*, const void*,
                                 const void*, void*, int, float, float, void*);

extern "C" int madpp_tagging_step(
    const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, const void*, const void*, const void*, const void*,
    const void*, const void*, void*, void*, const void*, int, int, int, int, int, int, int,
    int, void*);
extern "C" int madpp_tagging_cluster(int, int);

extern "C" int madpp_associate(const void*, const void*, void*, int, int, float, void*, void*);
extern "C" long long madpp_associate_scratch(int, int);
extern "C" int madpp_associate_cluster(int, int);

extern "C" int madpp_nms_keep(const void*, const void*, void*, int, int, float, void*);
extern "C" int madpp_nms_keep_large(const void*, const void*, void*, void*, void*, int, int, float, void*);

extern "C" int madpp_plan_step(const void*, const void*, const void*, const void*, const void*, const void*,
                               const void*, const void*, const void*, const void*, void*, void*, int, int, int,
                               int, int, int, int, int, int, int, float, float, float, float, float, float,
                               void*);

namespace {

inline void* ptr(std::uintptr_t p) { return reinterpret_cast<void*>(p); }

int tracker_step(pybind11::args a) {
  if (a.size() != 27) throw std::invalid_argument("tracker_step takes 27 arguments");
  void* p[19];
  for (int i = 0; i < 19; ++i) p[i] = ptr(a[i].cast<std::uintptr_t>());
  return madpp_tracker_step(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], p[12],
      p[13], p[14], p[15], p[16], p[17], p[18], a[19].cast<int>(), a[20].cast<int>(),
      a[21].cast<int>(), a[22].cast<int>(), a[23].cast<float>(), a[24].cast<int>(),
      a[25].cast<int>(), ptr(a[26].cast<std::uintptr_t>()));
}

int kalman_step(pybind11::args a) {
  if (a.size() != 14) throw std::invalid_argument("kalman_step takes 14 arguments");
  void* p[10];
  for (int i = 0; i < 10; ++i) p[i] = ptr(a[i].cast<std::uintptr_t>());
  return madpp_kalman_step(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
                           a[10].cast<int>(), a[11].cast<float>(), a[12].cast<float>(),
                           ptr(a[13].cast<std::uintptr_t>()));
}

int tagging_step(pybind11::args a) {
  if (a.size() != 32) throw std::invalid_argument("tagging_step takes 32 arguments");
  void* p[23];
  for (int i = 0; i < 23; ++i) p[i] = ptr(a[i].cast<std::uintptr_t>());
  int n[8];
  for (int i = 0; i < 8; ++i) n[i] = a[23 + i].cast<int>();
  return madpp_tagging_step(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
                            p[10], p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18],
                            p[19], p[20], p[21], p[22], n[0], n[1], n[2], n[3], n[4], n[5],
                            n[6], n[7], ptr(a[31].cast<std::uintptr_t>()));
}

int associate(pybind11::args a) {
  if (a.size() != 8) throw std::invalid_argument("associate takes 8 arguments");
  return madpp_associate(ptr(a[0].cast<std::uintptr_t>()), ptr(a[1].cast<std::uintptr_t>()),
                         ptr(a[2].cast<std::uintptr_t>()), a[3].cast<int>(), a[4].cast<int>(),
                         a[5].cast<float>(), ptr(a[6].cast<std::uintptr_t>()), ptr(a[7].cast<std::uintptr_t>()));
}

int nms_keep(pybind11::args a) {
  if (a.size() != 7) throw std::invalid_argument("nms_keep takes 7 arguments");
  return madpp_nms_keep(ptr(a[0].cast<std::uintptr_t>()), ptr(a[1].cast<std::uintptr_t>()),
                        ptr(a[2].cast<std::uintptr_t>()), a[3].cast<int>(), a[4].cast<int>(),
                        a[5].cast<float>(), ptr(a[6].cast<std::uintptr_t>()));
}

int nms_keep_large(pybind11::args a) {
  if (a.size() != 9) throw std::invalid_argument("nms_keep_large takes 9 arguments");
  void* p[5];
  for (int i = 0; i < 5; ++i) p[i] = ptr(a[i].cast<std::uintptr_t>());
  return madpp_nms_keep_large(p[0], p[1], p[2], p[3], p[4], a[5].cast<int>(), a[6].cast<int>(), a[7].cast<float>(),
                              ptr(a[8].cast<std::uintptr_t>()));
}

int plan_step(pybind11::args a) {
  if (a.size() != 29) throw std::invalid_argument("plan_step takes 29 arguments");
  void* p[12];
  for (int i = 0; i < 12; ++i) p[i] = ptr(a[i].cast<std::uintptr_t>());
  int n[10];
  for (int i = 0; i < 10; ++i) n[i] = a[12 + i].cast<int>();
  float w[6];
  for (int i = 0; i < 6; ++i) w[i] = a[22 + i].cast<float>();
  return madpp_plan_step(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], n[0], n[1],
                         n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9], w[0], w[1], w[2], w[3], w[4], w[5],
                         ptr(a[28].cast<std::uintptr_t>()));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("tracker_step", &tracker_step, "Launch kernel K1; returns the CUDA error code.");
  m.def("kalman_step", &kalman_step, "Launch kernel K2; returns the CUDA error code.");
  m.def("tagging_step", &tagging_step, "Launch kernel K3; returns the CUDA error code.");
  m.def("associate", &associate, "Launch kernel K4; returns the CUDA error code.");
  m.def("tracker_scratch", &madpp_tracker_scratch, "K1's key scratch words a lane at (T, D, L); -1 outside its limits.");
  m.def("tracker_cluster", &madpp_tracker_cluster, "K1's blocks a lane at (T, D, L); -1 outside its limits.");
  m.def("tagging_cluster", &madpp_tagging_cluster, "K3's blocks a lane at (T, D); -1 outside its limits.");
  m.def("associate_scratch", &madpp_associate_scratch, "K4's key scratch words at (T, D); -1 outside its limits.");
  m.def("associate_cluster", &madpp_associate_cluster, "K4's blocks at (T, D); -1 outside its limits.");
  m.def("nms_keep", &nms_keep, "Launch kernel K5; returns the CUDA error code.");
  m.def("nms_keep_large", &nms_keep_large, "Launch K5's large instance (K > 1,024); returns the CUDA error code.");
  m.def("plan_step", &plan_step, "Launch kernel K6; returns the CUDA error code.");
}
